"""snarkjs proving_key.json -> binary .bin converter (tools/buildpkey.js
parity): consumes the old-snarkjs ("groth" protocol) JSON proving key
{nVars, nPublic, domainSize, polsA, polsB, A, B1, B2, C, hExps, vk_alfa_1,
vk_beta_1, vk_delta_1, vk_beta_2, vk_delta_2} and emits the header and
sections of buildpkey.js:188-240 (points and Fr coefficients in Montgomery
form, 32 B little-endian).
"""

from __future__ import annotations

import argparse
import json
import sys

from ..groth16.pkey import write_pkey
from ..models.bn128 import bn128
from ..utils.serialize import ints_to_limbs_fast, parse_bigint


def _g1(pt):
    x, y = parse_bigint(pt[0]), parse_bigint(pt[1])
    if len(pt) > 2 and parse_bigint(pt[2]) == 0:
        return None
    if x == 0 and y == 0:
        return None
    return (x, y)


def _g2(pt):
    if len(pt) > 2 and [parse_bigint(c) for c in pt[2]] == [0, 0]:
        return None
    x = (parse_bigint(pt[0][0]), parse_bigint(pt[0][1]))
    y = (parse_bigint(pt[1][0]), parse_bigint(pt[1][1]))
    return (x, y)


def _planes(fp, pts, coords):
    """Affine points (None for zero) -> Montgomery limb planes, one per
    coordinate picked by `coords` (zero is all-zero)."""
    return [ints_to_limbs_fast([0 if p is None else fp.to_mont(c(p))
                                for p in pts], fp.n_limbs) for c in coords]


def _g1_planes(fp, pts):
    return tuple(_planes(fp, pts, (lambda p: p[0], lambda p: p[1])))


def _g2_planes(fp, pts):
    x0, x1, y0, y1 = _planes(fp, pts, (
        lambda p: p[0][0], lambda p: p[0][1],
        lambda p: p[1][0], lambda p: p[1][1]))
    return ((x0, x1), (y0, y1))


def convert(pk: dict) -> bytes:
    m = bn128()
    fp = m.fp_spec
    n_vars = int(pk["nVars"])
    n_public = int(pk["nPublic"])

    def pol(p):
        # JSON object {constraintIdx: coef}; keys may be int or str
        return {int(k): parse_bigint(v) for k, v in p.items()}

    return write_pkey(
        fp, m.fr_spec,
        n_public=n_public,
        domain_size=int(pk["domainSize"]),
        alfa1=_g1(pk["vk_alfa_1"]),
        beta1=_g1(pk["vk_beta_1"]),
        delta1=_g1(pk["vk_delta_1"]),
        beta2=_g2(pk["vk_beta_2"]),
        delta2=_g2(pk["vk_delta_2"]),
        pols_a=[pol(pk["polsA"][i]) for i in range(n_vars)],
        pols_b=[pol(pk["polsB"][i]) for i in range(n_vars)],
        points_a=_g1_planes(fp, [_g1(p) for p in pk["A"][:n_vars]]),
        points_b1=_g1_planes(fp, [_g1(p) for p in pk["B1"][:n_vars]]),
        points_b2=_g2_planes(fp, [_g2(p) for p in pk["B2"][:n_vars]]),
        # C is indexed from nPublic+1 in the JSON (buildpkey.js:173-176)
        points_c=_g1_planes(fp, [_g1(pk["C"][i])
                                 for i in range(n_public + 1, n_vars)]),
        h_exps=_g1_planes(fp, [_g1(p)
                               for p in pk["hExps"][:int(pk["domainSize"])]]),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert a snarkjs proving_key.json to wasmsnark "
                    "binary format (tools/buildpkey.js parity)")
    ap.add_argument("-i", "--input", default="proving_key.json")
    ap.add_argument("-o", "--output", default="proving_key.bin")
    args = ap.parse_args(argv)
    with open(args.input) as f:
        pk = json.load(f)
    data = convert(pk)
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"wrote {len(data)} bytes to {args.output}")


if __name__ == "__main__":
    sys.exit(main())
