"""Tools run by hand: the measurement tools of the card's kernels
(bilinear_conv_variants, conv_stem_variants, thin_s2_variants, conv5_dw),
the ports of the repository's data and quality tools (make_synthetic,
build_dataset, pick_epoch, compare_published, import_reference_weights)
and of its artifact tools (make_filmstrip, make_gen_sheet, pack_artifacts,
render_clip: PNGs through serve/png.py, the clip's GIF through
serve/gif.py, no image library) and of its trace tool (summarize_trace: a
torch.profiler trace's device time by kernel, family and launching op,
ranked by roofline headroom), each run as
`python -m terrain_tpu_torch.tools.<name>`.  None is on a main path."""
