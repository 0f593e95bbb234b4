"""Architecture diagrams: one box per parameterized block of a network
(terrain_tpu/utils/arch_diagram.py, without JAX).

The boxes come from the network's terrain_tpu tree (models/convert.to_jax):
the leaves grouped by their parent key path, in the tree's order, each
labeled with the op kind, its weight shape and its parameter count,
connected top to bottom, with the factory config in the title -- the
blocks terrain_tpu draws for the same network.  Drawing needs matplotlib
(imported at the call); the trainer writes the picture where it imports
and says so where it does not (train/trainer.py).
"""

import numpy as np

from terrain_tpu_torch.models.core import keystr, tree_leaves_with_path


def _blocks(params):
    """Group param leaves by their parent path -> ordered block list
    [(label, {leafname: shape}, n_params), ...] in tree order."""
    order = []
    groups = {}
    for path, leaf in tree_leaves_with_path(params):
        parent = keystr(path[:-1]) or "(root)"
        name = keystr(path[-1:]).strip("[]'\"")
        if parent not in groups:
            groups[parent] = {}
            order.append(parent)
        groups[parent][name] = tuple(leaf.shape)
    out = []
    for parent in order:
        leaves = groups[parent]
        n = sum(int(np.prod(s)) for s in leaves.values())
        out.append((parent, leaves, n))
    return out


def _kind(leaves):
    """Human label for a block from its leaf shapes."""
    if "w" in leaves:
        s = leaves["w"]
        if len(s) == 4:
            return f"conv {s[0]}x{s[1]} {s[2]}→{s[3]}"
        if len(s) == 2:
            return f"dense {s[0]}→{s[1]}"
    if set(leaves) >= {"gamma", "beta"}:
        return f"batchnorm ({leaves['gamma'][0]})"
    return ", ".join(sorted(leaves))


def draw_network(net, path):
    """Render `net`'s block diagram to `path` (PNG).  Returns the block
    count.  Raises ImportError without matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import FancyArrow, Rectangle

    from terrain_tpu_torch.models import convert

    blocks = _blocks(convert.to_jax(net)[0])
    n = len(blocks)
    total = sum(b[2] for b in blocks)
    fig_h = max(2.0, 0.42 * n + 1.2)
    fig, ax = plt.subplots(figsize=(7.2, fig_h))
    ax.set_xlim(0, 1)
    ax.set_ylim(0, n)
    ax.axis("off")
    cfg = "  ".join(f"{k}={v!r}" for k, v in sorted(net.config.items()))
    ax.set_title(f"{net.name} — {total:,} params\n{cfg}",
                 fontsize=7, loc="left", family="monospace")
    # color by op family, like nolearn's per-layer-type coloring
    colors = {"conv": "#cfe8ff", "dense": "#ffe3c2", "batchnorm": "#e4f7d7"}
    for i, (parent, leaves, cnt) in enumerate(blocks):
        y = n - 1 - i
        kind = _kind(leaves)
        fam = kind.split()[0]
        ax.add_patch(Rectangle((0.08, y + 0.08), 0.84, 0.84,
                               facecolor=colors.get(fam, "#eeeeee"),
                               edgecolor="#333333", linewidth=0.6))
        ax.text(0.11, y + 0.5, f"{parent}", fontsize=6.5,
                va="center", family="monospace")
        ax.text(0.89, y + 0.5, f"{kind}   {cnt:,}", fontsize=6.5,
                va="center", ha="right", family="monospace")
        if i < n - 1:
            ax.add_patch(FancyArrow(0.5, y + 0.06, 0, -0.04, width=0.0005,
                                    head_width=0.015, head_length=0.02,
                                    color="#333333"))
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return n
