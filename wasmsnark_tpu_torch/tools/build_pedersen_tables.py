"""Pedersen base-table generator (tools/buildpedersentablebases_mnt6753.js
parity): from the 12 hardcoded MNT6753 base points, the affine {B, 2B, 3B,
4B} table per base, in Montgomery form, as JSON (the reference emits a JS
module of the same data; build_pedersenhash.js:20-38 documents the
layout).

    python -m wasmsnark_tpu_torch.tools.build_pedersen_tables -o pedersen_table.json
"""

from __future__ import annotations

import argparse
import json
import sys


def build_table():
    from ..models.mnt6753 import mnt6753
    from ..models.mnt6753_constants import PEDERSEN_BASES

    m = mnt6753()
    fp = m.fp_spec
    out = []
    for bx, by in PEDERSEN_BASES:
        p1 = m.G1.from_affine(bx, by)
        p2 = m.G1.affine(m.G1.double(p1))
        p3 = m.G1.affine(m.G1.add(p1, p2))
        p4 = m.G1.affine(m.G1.double(p2))
        out.append([{"x": str(fp.to_mont(p[0])), "y": str(fp.to_mont(p[1]))}
                    for p in (m.G1.affine(p1), p2, p3, p4)])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default="-")
    args = ap.parse_args(argv)
    data = {"curve": "mnt6753", "form": "montgomery-affine",
            "layout": "[base][sel] sel=0..3 -> (sel+1)*B",
            "table": build_table()}
    text = json.dumps(data, indent=1)
    if args.output == "-":
        sys.stdout.write(text + "\n")
    else:
        with open(args.output, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
