"""Offline converters, the port's copies of wasmsnark_tpu/tools (parity
with the reference's tools/ CLI); host-only, they need no card:

    python -m wasmsnark_tpu_torch.tools.build_pkey    -i proving_key.json -o proving_key.bin
    python -m wasmsnark_tpu_torch.tools.build_witness -i witness.json     -o witness.bin
    python -m wasmsnark_tpu_torch.tools.build_pedersen_tables -o pedersen_table.json

Keys are stored pre-Montgomery in the binary layout the prover slices by
header pointers (tools/buildpkey.js, tools/buildwitness.js).
"""
