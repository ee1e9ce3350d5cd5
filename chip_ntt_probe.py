#!/usr/bin/env python3
"""Where a K3 transform's time goes on one NVIDIA card.

    python3 chip_ntt_probe.py

Run from the root of a checkout on a machine with the CUDA toolkit and a
card.  It builds the kernels (ops/cuda_lib.py) and, over BN128's Fr at 2^16
and 2^17 points (random canonical planes from a seeded generator):

  - times each pass of ops/ntt.py's split alone, with and without its end
    (pass 1 with and without the bit-reverse gather, the last pass with
    and without the mirror and 1/N), a pass of no stages (a read and a
    write of the planes, with and without the gather) and the first one
    and five stages on 1,024-element tiles, as 20 launches in a row
    between two CUDA events behind a ~1 ms sleep (the median of five);
  - times NTTDevice.fft and ifft under other splits (SPLITS: 1,024-element
    tiles in two passes, and three passes of 512 or 256 elements), each
    bit-equal to the committed split's result, the same way, in two
    rounds;
  - times the 2^21 ifft(fft(x)) round trip, which must return x.

It prints each time as it goes and, as the last line, one JSON object of
all of them with the card's name and power limit.  Without a CUDA device
it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261017
SIZES = (16, 17)                 # log2 of the points of the transforms
ROUND_TRIP_LOG = 21
# other pass splits, (s0, s1, tile_log) a pass, at 2^bits points
SPLITS = {
    "1024 x2": lambda bits: [(0, 10, 10), (10, bits, 10)],
    "512 x3": lambda bits: [(0, 9, 9), (9, 15, 9), (15, bits, 9)],
    "256 x3": lambda bits: [(0, 8, 8), (8, 14, 8), (14, bits, 8)],
}


def stream_ms(fn, reps=20):
    """Milliseconds a call in a stream of reps calls behind a ~1 ms device
    sleep, the median of five streams."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(5):
        torch.cuda._sleep(2_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return sorted(out)[2]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_ntt_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from wasmsnark_tpu_torch.models.bn128 import bn128
    from wasmsnark_tpu_torch.ops import cuda_lib, fp, ntt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    cuda_lib.build()
    m = bn128()
    fr = m.fr_spec
    dev = torch.device("cuda")
    nd = ntt.NTTDevice(m.ntt_spec, fp.FpDevice(fr, dev))
    rng = np.random.default_rng(SEED)

    def rand(n):
        a = rng.integers(0, 1 << 16, size=(fr.n_limbs, n), dtype=np.uint32)
        a[-1] = rng.integers(0, fr.q_limbs[-1], size=n, dtype=np.uint32)
        return fp.planes(a, dev)

    res = {"device": smi}

    def note(key, ms):
        res[key] = ms
        print(f"{key}: {ms:.4f} ms", flush=True)

    committed = ntt.ntt_passes
    for bits in SIZES:
        n = 1 << bits
        x, out = rand(n), torch.empty((fr.n_limbs, n), dtype=torch.int32,
                                      device=dev)
        p = nd.plan(bits, False, True)

        def launch(s0, s1, flags, tile_log):
            return lambda: cuda_lib.launch(
                "k3_ntt_pass", fr, (x, p["tw"], p["invn"], out),
                (n, s0, s1, flags, tile_log))

        for s0, s1, t in committed(bits):
            for flags, end in ((0, ""), (1, " gather"), (2, " mirror")):
                note(f"{bits} pass {s0}-{s1} tile {1 << t}{end}",
                     stream_ms(launch(s0, s1, flags, t)))
        for s1, flags, end in ((0, 0, ""), (0, 1, " gather"), (1, 0, ""),
                               (5, 0, "")):
            note(f"{bits} pass 0-{s1} tile 1024{end}",
                 stream_ms(launch(0, s1, flags, 10)))
        want = (nd.fft(x), nd.ifft(x))
        for rnd in range(2):
            for name, split in {"committed": committed, **SPLITS}.items():
                ntt.ntt_passes = split
                try:
                    got = (nd.fft(x), nd.ifft(x))
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"split {name} disagrees at "
                                             f"2^{bits}")
                    for kind in ("fft", "ifft"):
                        fn = getattr(nd, kind)
                        note(f"{bits} {kind} {name} round {rnd}",
                             stream_ms(lambda fn=fn: fn(x)))
                finally:
                    ntt.ntt_passes = committed
    x = rand(1 << ROUND_TRIP_LOG)
    if not torch.equal(nd.ifft(nd.fft(x)), x):
        raise AssertionError(f"ifft(fft(x)) != x at 2^{ROUND_TRIP_LOG}")
    note(f"{ROUND_TRIP_LOG} round trip",
         stream_ms(lambda: nd.ifft(nd.fft(x)), reps=5))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
