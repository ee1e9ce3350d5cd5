"""witness.json -> binary .bin converter (tools/buildwitness.js parity):
a flat array of decimal-string Fr values becomes flat LE 32-byte values,
no header (buildwitness.js:65-69)."""

from __future__ import annotations

import argparse
import json
import sys

from ..utils.serialize import int_to_bytes_le, parse_bigint


def convert(witness: list) -> bytes:
    return b"".join(int_to_bytes_le(parse_bigint(v), 32) for v in witness)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert witness.json to wasmsnark binary format")
    ap.add_argument("-i", "--input", default="witness.json")
    ap.add_argument("-o", "--output", default="witness.bin")
    args = ap.parse_args(argv)
    with open(args.input) as f:
        wit = json.load(f)
    data = convert(wit)
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"wrote {len(data)} bytes to {args.output}")


if __name__ == "__main__":
    sys.exit(main())
