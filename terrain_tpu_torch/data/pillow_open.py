"""How imageio fails on a file too short for any reader, shared by the
decoders of the formats it reads through Pillow (data/sgi.py, pcx.py,
qoi.py, im.py, ico.py, icns.py and jpeg.py)."""

import struct


def check_tiny(buf, least=4):
    """imageio on a file of fewer than `least` bytes, which no reader
    identifies: OSError for an empty one, struct.error for a shorter one (a
    legacy Pillow reader's unpack of its first 4 bytes).  Pillow's JPEG
    reader identifies 3 bytes (FF D8 FF), so the JPEG decoder asks for 3."""
    if not buf:
        raise OSError("imageio: no reader opens an empty file")
    if len(buf) < least:
        raise struct.error(f"imageio: a file of {len(buf)} bytes (unpack "
                           f"needs 4)")
