"""Groth16 prover for BN128 and BLS12-381, PyTorch port of
wasmsnark_tpu/groth16/prover.py — the pipeline of the reference's
src/bn128.js:580-720, curve-generic as the JAX package's.

  CALC_H   to_mont, two constructLC, two iNTT, two odd-coset NTT,
           pointwise mont_mul, one 2N-point iNTT, from_mont (on the device)
  5 MSMs   four over G1, folded to one point each on the device; one over
           G2, its window sums folded on the host (fold_windows)
  host     r/s randomization and the affine proof (oracle group ops)

Over a mesh (parallel/mesh.py; one process a rank): each MSM runs point-
sharded (ShardedMSM; G1's folded on the device, G2's gathered window sums
on the host as without a mesh), the key's point sections uploaded only
as this rank's blocks; CALC_H runs split over the mesh's first axis (the
JAX prover's domain axis, `_calc_h_split`), each rank on its part of the
domain with only its QAP rows uploaded, and its block of H goes to its
block of the h_exps MSM; every rank assembles the same proof from the
same window sums and rng.  A mesh the split cannot serve (ranks not a
power of two, a domain under D^2 points) runs CALC_H whole on every
rank; `calc_h_path` says which ran.

Randomization parity: r and s are 32 unreduced random bytes and the r*s
term uses their full product, as in the reference, so for the same key,
witness and rng the proof JSON equals the JAX package's byte for byte, on
either curve.

Spans (utils/spans.py): "prove" around a proof, and inside it one a phase,
"prove.key_and_witness", "prove.calc_h", "prove.msm_g1", "prove.msm_g2"
and "prove.host_assembly"; `prove(timings=)` reads their seconds.
"""

from __future__ import annotations

import functools
import os
import random

import torch

from ..models import curve_module
from ..ops.curve import JacobianDevice, host_points, map_leaf
from ..ops.fp import FpDevice, planes, resolve_device
from ..ops.msm import MSMDevice, fold_windows
from ..ops.ntt import NTTDevice
from ..ops.pol import construct_lc, lc_arrays
from ..ops.towers import FpAdapter, F2Device
from ..utils.keys import KeyCache
from ..utils.serialize import bytes_le_to_int, ints_to_limbs_fast
from ..utils.spans import span
from .pkey import ProvingKey, parse_pkey, read_witness

_G1_SECTIONS = ("points_a", "points_b1", "points_c", "h_exps")


class Groth16Prover:
    """Device kernel objects and per-key device state for one curve,
    "bn128" or "bls12381" (every kernel takes the field's spec).

    mesh: a DeviceMesh of parallel/mesh.py, on this prover's device type,
    whose "points" axis shards the MSMs; msm_window_bits: the MSM window
    (default by size, `_window_for`)."""

    def __init__(self, device=None, curve: str = "bn128", mesh=None,
                 msm_window_bits: int | None = None):
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a prover on "
                             f"{self.device.type}")
        self.mesh = mesh
        self.window_bits = msm_window_bits
        self._sharded: dict = {}
        # under a mesh, how the last CALC_H ran: "sharded" or "whole" (and
        # why), and whether H was re-cut to the MSM's blocks (a collective)
        self.calc_h_path = self.calc_h_whole_reason = None
        self.h_recut = False
        self._split: dict = {}
        self.m = curve_module(curve)
        self.Fp = FpDevice(self.m.fp_spec, self.device)
        self.Fr = FpDevice(self.m.fr_spec, self.device)
        self.ntt = NTTDevice(self.m.ntt_spec, self.Fr)
        a1 = FpAdapter(self.Fp)
        self.G1d = JacobianDevice(a1)
        self.G2d = JacobianDevice(F2Device(a1, a1.neg))
        # id -> (bytes ref, ProvingKey, device state): repeated proves with
        # the same key bytes skip the parse and the upload
        self._keys = KeyCache()

    def _window_for(self, n: int) -> int:
        """The JAX package's window policy (the result does not depend on
        it)."""
        if self.window_bits:
            return self.window_bits
        return 16 if n >= (1 << 16) else 12 if n >= (1 << 12) else 8 \
            if n >= (1 << 7) else 4

    def _sharded_msm(self, curve, n: int, fold: bool = True):
        """A ShardedMSM over the mesh's "points" axis, for an MSM of n
        points (its window by n, as without a mesh), its window sums folded
        on the device (msm_sharded_point) or, with fold=False, not
        (msm_sharded)."""
        c = self._window_for(n)
        key = (id(curve), c, fold)
        if key not in self._sharded:
            from ..parallel.mesh import ShardedMSM
            self._sharded[key] = ShardedMSM(
                MSMDevice(curve, window_bits=c), self.mesh, fold=fold)
        return self._sharded[key]

    def _msm_g2(self, scalars, points):
        """The G2 MSM as a host point.  Its W window sums are copied to the
        host, where the proof is assembled, and folded there (fold_windows):
        G2 has no fused doubling, so a device fold is ~8,400 one-lane
        launches at c = 16, the host fold ~10 ms.  Under a mesh, scalars
        are whole ([L, n], cut here), points this rank's block, and the
        window sums every rank's, gathered."""
        n = scalars.shape[-1]
        with span("msm"):
            if self.mesh is None:
                msm = MSMDevice(self.G2d, window_bits=self._window_for(n))
                win = msm.msm(scalars, points)
            else:
                sh = self._sharded_msm(self.G2d, n, fold=False)
                msm, win = sh.msm, sh.local(sh.shard(scalars), points)
            with span("msm.fold"):
                return fold_windows(self.m.G2, host_points(self.Fp, win),
                                    msm.c)

    def _key(self, pkey):
        """(ProvingKey, device state) for bytes or a parsed ProvingKey,
        kept by id(pkey) beside pkey itself: a hit must be pkey, not an
        object that took a freed key's id()."""
        hit = self._keys.get(id(pkey), lambda: (pkey, *self._load(pkey)))
        if hit[0] is not pkey:
            self._keys.pop(id(pkey))
            return self._key(pkey)
        return hit[1], hit[2]

    def _load(self, pkey):
        """Parse and upload a key -> (ProvingKey, device state)."""
        pk = pkey if isinstance(pkey, ProvingKey) else \
            parse_pkey(pkey, self.m.fp_spec, self.m.fr_spec)
        # the four G1 sections zero-padded to one length and stacked, so
        # their MSMs run as one batch (zero points (0, 0) and zero digits
        # add nothing)
        n_pad = max(getattr(pk, nm)[0].shape[-1] for nm in _G1_SECTIONS)
        if self.mesh is None:
            def place(a, n=None):
                t = planes(a, self.device)
                return t if n is None else torch.nn.functional.pad(
                    t, (0, n - t.shape[-1]))
        else:
            # this rank's blocks only (a block depends on the mesh and the
            # length alone)
            place = self._sharded_msm(self.G1d, n_pad).shard

        def stack(*secs):
            return torch.stack([place(a, n_pad) for a in secs], dim=1)

        g1 = [getattr(pk, nm) for nm in _G1_SECTIONS]
        dev = {"g1": (stack(*[s[0] for s in g1]), stack(*[s[1] for s in g1])),
               "n_pad": n_pad,
               "points_b2": map_leaf(pk.points_b2, place),
               **self._qap(pk)}
        return pk, dev

    # -- CALC_H -----------------------------------------------------------------

    def _calc_h_split(self, n: int):
        """The ShardedNTT over the mesh's first axis for a domain of n
        points, or None (no mesh, or one the split cannot serve)."""
        if self.mesh is None:
            return None
        if n not in self._split:
            from ..parallel.mesh import ShardedNTT
            sh = ShardedNTT(self.ntt, self.mesh)
            self._split[n] = (sh, sh.unsupported(n))
        sh, why = self._split[n]
        return None if why else sh

    def _qap(self, pk: ProvingKey) -> dict:
        """The QAP tables on the device: under a split CALC_H only the
        entries of this rank's domain columns ("chunks_rev")."""
        sh = self._calc_h_split(pk.domain_size)
        cols = None
        if sh is not None:
            from ..parallel.mesh import layout
            cols = layout("chunks_rev", pk.domain_size, sh.D, sh.index)
        return {"lca": lc_arrays(pk.pols_a, self.device, cols),
                "lcb": lc_arrays(pk.pols_b, self.device, cols)}

    def calc_h(self, pk: ProvingKey, signals, dev=None):
        """signals: [L, nSignals] canonical planes on the device.  Returns
        [L, domain] canonical H coefficients (upper half of A*B); under a
        mesh this rank's block of them over the mesh's first axis, [L,
        ceil(domain / D)] (the JAX prover's P(None, axis) block)."""
        if dev is None:
            dev = self._qap(pk)
        h = self._calc_h(pk, signals, dev)
        if self.mesh is None or self.calc_h_path == "sharded":
            return h
        sh, _ = self._split[pk.domain_size]
        per = -(-h.shape[1] // sh.D)
        h = h[:, sh.index * per:(sh.index + 1) * per]
        return torch.nn.functional.pad(h, (0, per - h.shape[1]))

    def _calc_h(self, pk: ProvingKey, signals, dev):
        """H whole, or this rank's block of it where CALC_H runs split."""
        n = pk.domain_size
        sh = self._calc_h_split(n)
        if self.mesh is not None:
            self.calc_h_path = "whole" if sh is None else "sharded"
            self.calc_h_whole_reason = self._split[n][1]
        Fr, ntt = self.Fr, self.ntt
        bits = n.bit_length() - 1
        sig_m = Fr.to_mont(signals)
        ea = construct_lc(Fr, dev["lca"], sig_m)
        eb = construct_lc(Fr, dev["lcb"], sig_m)
        if sh is not None:
            return self._calc_h_sharded(sh, n, ea, eb)
        pinv = ntt.plan(bits, inverse=True)
        podd = ntt.plan(bits, odd=True)
        ca = ntt.ifft(ea, plan=pinv)
        cb = ntt.ifft(eb, plan=pinv)
        oa = ntt.fft(ca, odd=True, plan=podd)
        ob = ntt.fft(cb, odd=True, plan=podd)
        L, n = ea.shape
        a2 = torch.stack([ea, oa], dim=-1).reshape(L, 2 * n)
        b2 = torch.stack([eb, ob], dim=-1).reshape(L, 2 * n)
        c2 = Fr.mont_mul(a2, b2)
        cc = ntt.ifft(c2, plan=ntt.plan(bits + 1, inverse=True))
        return Fr.from_mont(cc[:, n:])

    def _calc_h_sharded(self, sh, n: int, ea, eb):
        """CALC_H's transforms split over the ranks (parallel/mesh.py
        ShardedNTT), from ea and eb in layout "chunks_rev" (construct_lc
        on this rank's columns) to this rank's block of H: the inverses
        chunks in, strided out; the odd transforms strided in, chunks out;
        the interleave and the product local (a rank's chunks of the two
        N-point results are its chunks of the 2N-point arrays); the
        2N-point inverse chunks in, strided out; and one last exchange
        that sends each coefficient of the upper half straight to the rank
        of its block of H.  Four exchanges in all (one rank: none)."""
        Fr = self.Fr
        ca, cb = sh.chunks_in([ea, eb], n, label="ifft")
        oa, ob = sh.strided_in([ca, cb], n, odd=True, label="fft_odd")
        del ca, cb
        oa, ob = sh.exchange([oa, ob], "chunks", "chunks_rev", n, "local")
        L, m = ea.shape

        def interleave(e, o):
            return torch.stack([e.view(L, -1, sh.D), o.view(L, -1, sh.D)],
                               dim=2).reshape(L, 2 * m)

        c2 = Fr.mont_mul(interleave(ea, oa), interleave(eb, ob))
        del oa, ob
        cc, = sh.chunks_in([c2], 2 * n, label="ifft_2n")
        del c2
        h, = sh.exchange([cc], "strided", "upper", 2 * n, "h_blocks")
        return Fr.from_mont(h)

    # -- proof ------------------------------------------------------------------

    def _phase(self, timings, name: str):
        """The span of one phase of prove, "prove.<name>".  With a timings
        dict it is timed whether or not spans are recorded, synchronizes
        the device at its end and gives its seconds to timings[name]."""
        if timings is None:
            return span("prove." + name)
        return span("prove." + name, sync=self.device, into=(timings, name))

    def prove(self, witness, pkey, rng=None, timings=None) -> dict:
        """timings: if a dict, receives the seconds of each phase (key and
        witness upload, calc_h, msm_g1, msm_g2, host assembly), each its
        span's, with a device synchronize at the end of each."""
        with span("prove"):
            return self._prove(witness, pkey, rng, timings)

    def _prove(self, witness, pkey, rng, timings) -> dict:
        m = self.m
        with self._phase(timings, "key_and_witness"):
            pk, dev = self._key(pkey)
            if isinstance(witness, (bytes, bytearray)):
                sig_np = read_witness(bytes(witness), m.fr_spec)
            else:
                sig_np = ints_to_limbs_fast(
                    [int(v) % m.Fr.q for v in witness], m.fr_spec.n_limbs)
            if sig_np.shape[1] != pk.n_signals:
                raise ValueError(f"witness has {sig_np.shape[1]} signals, "
                                 f"the key {pk.n_signals}")
            sig = planes(sig_np, self.device)

        with self._phase(timings, "calc_h"):
            h = self._calc_h(pk, sig, dev)
        with self._phase(timings, "msm_g1"):
            n_pad = dev["n_pad"]
            secs = (sig, sig, sig[:, pk.n_public + 1:])
            if self.mesh is None:
                sc = torch.stack([torch.nn.functional.pad(
                    s, (0, n_pad - s.shape[-1])) for s in secs + (h,)],
                    dim=1)
                g1 = MSMDevice(self.G1d, window_bits=self._window_for(
                    n_pad)).msm_point(sc, dev["g1"])       # leaves [L, 4]
            else:
                sh = self._sharded_msm(self.G1d, n_pad)
                sc = torch.stack(
                    [sh.shard(s, n_pad) for s in secs]
                    + [self._h_block(sh, h, pk.domain_size, n_pad)],
                    dim=1)                                 # [L, 4, block]
                g1 = sh.local(sc, dev["g1"])
            pi_a, pib1, pi_c, p_h = host_points(self.Fp, g1)
        with self._phase(timings, "msm_g2"):
            pi_b = self._msm_g2(sig, dev["points_b2"])

        with self._phase(timings, "host_assembly"):
            return self._assemble(pk, rng, pi_a, pi_b, pib1, pi_c, p_h)

    def _assemble(self, pk, rng, pi_a, pi_b, pib1, pi_c, p_h) -> dict:
        """The randomized assembly on the host (bn128.js:642-704) and the
        proof JSON."""
        G1, G2 = self.m.G1, self.m.G2
        if rng is None:
            rnd = os.urandom
        elif callable(rng):
            rnd = rng
        else:
            rnd = random.Random(rng).randbytes
        r = bytes_le_to_int(rnd(32))
        s = bytes_le_to_int(rnd(32))

        alfa1 = G1.from_affine(*pk.alfa1)
        beta1 = G1.from_affine(*pk.beta1)
        delta1 = G1.from_affine(*pk.delta1)
        beta2 = G2.from_affine(*pk.beta2)
        delta2 = G2.from_affine(*pk.delta2)

        pi_a = G1.add(pi_a, alfa1)
        pi_a = G1.add(pi_a, G1.times_scalar(delta1, r))

        pi_b = G2.add(pi_b, beta2)
        pi_b = G2.add(pi_b, G2.times_scalar(delta2, s))

        pib1 = G1.add(pib1, beta1)
        pib1 = G1.add(pib1, G1.times_scalar(delta1, s))

        pi_c = G1.add(pi_c, p_h)
        pi_c = G1.add(pi_c, G1.times_scalar(pi_a, s))
        pi_c = G1.add(pi_c, G1.times_scalar(pib1, r))
        pi_c = G1.add(pi_c, G1.neg(G1.times_scalar(delta1, r * s)))

        pa = G1.affine(pi_a)
        pb = G2.affine(pi_b)
        pc = G1.affine(pi_c)
        return {
            "pi_a": [str(pa[0]), str(pa[1]), str(pa[2])],
            "pi_b": [[str(pb[0][0]), str(pb[0][1])],
                     [str(pb[1][0]), str(pb[1][1])],
                     [str(pb[2][0]), str(pb[2][1])]],
            "pi_c": [str(pc[0]), str(pc[1]), str(pc[2])],
            "protocol": "groth",
        }

    def _h_block(self, sh, h, n: int, n_pad: int):
        """The MSM's block of H (sh: the ShardedMSM of the G1 MSMs) from
        CALC_H's output: its own block where the split's blocks over the
        mesh's first axis are the MSM's (one axis, n_pad = the domain),
        else H gathered whole over that axis (one collective) and cut."""
        self.h_recut = False
        if self.calc_h_path != "sharded":
            return sh.shard(h, n_pad)
        split = self._calc_h_split(n)
        if sh.axes == (split.axis,) and n_pad == n:
            return h
        self.h_recut = True
        return sh.shard(split.gather(h), n_pad)


@functools.lru_cache(maxsize=8)
def _prover(window_bits, curve) -> Groth16Prover:
    return Groth16Prover(curve=curve, msm_window_bits=window_bits)


def groth16_gen_proof(witness, pkey, *, rng=None, msm_window_bits=None,
                      curve: str = "bn128"):
    """Module-level prove on the card (the JAX package's entry point)."""
    return _prover(msm_window_bits, curve).prove(witness, pkey, rng=rng)
