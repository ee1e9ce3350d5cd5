"""snarkbench: the benchmark of wasmsnark_tpu_torch (see run.py)."""
