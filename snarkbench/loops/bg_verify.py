"""The Bowe-Gabizon verify loop: one MNT6753 verifier takes batches of
proofs against one key back to back, as Coda's verifier checks its
blockchain SNARK.  A proof is (A, B, C, dp, Z) and a lane passes two
equations, the second through a hash of the proof's points to the curve.
Traffic: batch, the lanes of a batch; batches, how many distinct batches
of valid proofs the window takes in turn (set-up makes one more for the
warm operation); tampered, the lanes of each kind a batch holds in
seed-drawn places; pairing_sample, the lanes the reference's pairing
verifies after the window, one of them a "z" lane; trace_ops.

The key and the proofs are made from the seed with a trapdoor (query_i =
q_i G1, alphaBeta = e(G1, G2)^k, delta = t G2).  A pool lane is a base's
A and B plus u G1 and v G2 from a table, each (base, u) and (base, v)
used once; dp = s delta for a 64-bit s of its own (d = s t); C from the
first equation; Z = s Ys, Ys from the reference's hash and group map."""

from __future__ import annotations

import dataclasses

from ..reference import mnt6753 as ref
from ..reference.curves import FixedBase
from . import FAULT_TYPES, stream, verify


@dataclasses.dataclass
class Lane:
    inputs: list      # decimal strings, as the verifier takes them
    proof: dict
    values: list      # the inputs as integers
    logs: tuple       # (a, b, c, s): A = aG1, B = bG2, C = cG1, dp = s delta
    points: tuple     # (A, B, C, dp, Z) affine, as the proof holds them


class PortBGVerifier:
    """bowe_gabizon_verify_batch of the port's MNT6753 runtime
    (build_mnt6753, models/mnt6753_runtime.py), with its defaults: the
    fused Miller loop, rho from os.urandom."""

    def __init__(self, device=None):
        import wasmsnark_tpu_torch as port
        self.rt = port.build_mnt6753(device=device)

    def verify_batch(self, vk: dict, inputs_list, proofs) -> list:
        return self.rt.bowe_gabizon_verify_batch(vk, inputs_list, proofs)


class Loop(verify.Loop):
    """The verify loop's batches (`batch`, `lane`, `op`) over lanes of its
    own."""
    kind = "bg_verify"

    def __init__(self, cfg, traffic, seed, device, program=None):
        super().__init__(cfg, traffic, seed, device, program)
        self._ys: dict = {}

    def prepare(self):
        cv = self.curve
        self.n_public = len(self.cfg["public_inputs"])
        self.td = ref.Trapdoor.draw(stream(self.seed, "key"), self.n_public)
        self.vk_json = ref.vk_json(cv, self.td)
        self.delta = ref.g2_of(self.vk_json["delta"])
        self.pool = self._pool(stream(self.seed, "pool"))
        rng = stream(self.seed, "tampered")
        self.bank = {kind: [self._tamper(kind, rng) for _ in range(4 * n)]
                     for kind, n in self.traffic["tampered"].items()}
        self.by_id = {(id(lane.inputs), id(lane.proof)): lane
                      for lane in self.pool + sum(self.bank.values(), [])}
        self.prog = self.program(self) if self.program else \
            PortBGVerifier(self.device)
        self.op(-1)

    def ys(self, quad):
        """Ys of (A, B, C, dp) by the reference, kept by the points."""
        if quad not in self._ys:
            self._ys[quad] = self.curve.ys_many([quad])[0]
        return self._ys[quad]

    def _c(self, values, a: int, b: int, s: int) -> int:
        """C's discrete log for these inputs, A, B and dp = s delta: the
        first equation solved with the trapdoor."""
        td, r = self.td, self.curve.r
        x = td.qs[0] + sum(v * q for v, q in zip(values, td.qs[1:]))
        return (a * b - td.k - x) * pow(s * td.t, -1, r) % r

    def _pool(self, rng) -> list:
        """(batches + 1) x batch valid proofs, every one with inputs of its
        own and A, B, C, dp and Z unlike any other's, their Ys hashed
        together."""
        cv, r, t = self.curve, self.curve.r, self.traffic
        G1, G2 = cv.G1, cv.G2
        n = (t["batches"] + 1) * t["batch"]
        k = -(-n // 255)
        per = -(-n // k)
        bases = []
        for _ in range(k):
            a, b = rng.randrange(1, r), rng.randrange(1, r)
            bases.append((a, b, cv.g1_mul(a), cv.g2_mul(b),
                          rng.sample(range(1, 256), per),
                          rng.sample(range(1, 256), per)))
        g1s, g2s = [G1.zero()], [G2.zero()]
        for _ in range(255):
            g1s.append(G1.add(g1s[-1], cv.g1))
            g2s.append(G2.add(g2s[-1], cv.g2))
        d_table = FixedBase(G2, G2.point(self.delta), 64)
        ss: dict = {}
        while len(ss) < n:
            ss[rng.randrange(1, 1 << 64)] = None
        ss = list(ss)
        rows = []
        for j in range(n):
            a0, b0, A0, B0, us, vs = bases[j % k]
            u, v, s = us[j // k], vs[j // k], ss[j]
            values = self._draw_inputs(rng)
            a, b = (a0 + u) % r, (b0 + v) % r
            c = self._c(values, a, b, s)
            quad = (G1.affine(G1.add(A0, g1s[u])),
                    G2.affine(G2.add(B0, g2s[v])),
                    G1.affine(cv.g1_mul(c)), G2.affine(d_table.mul(s)))
            rows.append((values, (a, b, c, s), quad))
        for (_, _, quad), y in zip(rows, cv.ys_many([q for _, _, q in rows])):
            self._ys[quad] = y
        return [self._lane(values, logs, quad + (
            G1.mul_affine(self._ys[quad], logs[3]),))
            for values, logs, quad in rows]

    def _lane(self, values, logs, points, proof=None) -> Lane:
        A, B, C, dp, Z = points
        proof = proof or {"a": ref.g1_json(A), "b": ref.g2_json(B),
                          "c": ref.g1_json(C), "deltaPrime": ref.g2_json(dp),
                          "z": ref.g1_json(Z)}
        return Lane([str(v) for v in values], proof, values, logs, points)

    def _tamper(self, kind: str, rng) -> Lane:
        """A pool lane with one change: "c" adds G1 to C (the first
        equation fails), "z" adds G1 to Z (the hash equation alone
        fails), "input" adds 1 to an input, "count" gives one input more
        than the key takes."""
        cv, r = self.curve, self.curve.r
        base = self.pool[rng.randrange(len(self.pool))]
        values, logs, points = list(base.values), base.logs, base.points
        if kind in ("c", "z"):
            at = 2 if kind == "c" else 4
            moved = cv.G1.affine(cv.G1.add(cv.G1.point(points[at]),
                                           cv.g1))
            pts = points[:at] + (moved,) + points[at + 1:]
            if kind == "c":
                logs = (logs[0], logs[1], (logs[2] + 1) % r, logs[3])
            return self._lane(values, logs, pts)
        if kind == "input":
            j = rng.randrange(len(values))
            values[j] = (values[j] + 1) % r
        else:
            values.append(rng.randrange(r))
        return self._lane(values, logs, points, proof=base.proof)

    def expected(self, ref_) -> bool:
        """The reference's verdict on a lane: both equations from the
        trapdoor, Ys worked out from the lane's own points."""
        if ref_ not in self._want:
            ln = self.lane(ref_)
            self._want[ref_] = ref.verify_exponent(
                self.curve, self.td, ln.values, ln.logs, ln.points, self.ys)
        return self._want[ref_]

    def sizes(self) -> dict:
        """The batch's lanes that reach the pairing: those whose input
        count the key takes."""
        return {"curve": self.cfg["curve"], "n_public": self.n_public,
                "fq_words": -(-self.curve.q.bit_length() // 32),
                "pairing_lanes": self.traffic["batch"]
                - self.traffic["tampered"].get("count", 0)}

    def check(self, ops) -> dict:
        """Every verdict of the window against the reference's, and a
        sample of lanes drawn from the seed, one of them a "z" lane where
        the window has such, verified by the reference's pairing from the
        very inputs and proof the program got."""
        wrong, seen = 0, []
        for op in ops:
            refs = self.batch(op.i)
            out = op.out
            if not isinstance(out, list) or len(out) != len(refs):
                wrong += len(refs)
                continue
            for x, v in zip(refs, out):
                if not (v is True or v is False) or v != self.expected(x):
                    wrong += 1
                seen.append((x, v))
        rng = stream(self.seed, "sample")
        n = self.traffic["pairing_sample"]
        zs = [s for s in seen if s[0][0] == "z"]
        pick = rng.sample(zs, min(len(zs), 1))
        rest = [s for s in seen if s[0][0] != "z"]
        pick += rng.sample(rest, min(len(rest), n - len(pick)))
        disagree = 0
        for x, v in pick:
            ln = self.lane(x)
            try:
                ok = ref.verify_bg(self.curve, self.vk_json, ln.inputs,
                                   ln.proof)
            except FAULT_TYPES:
                ok = None
            disagree += ok is None or ok != v or ok != self.expected(x)
        return {"verdicts_wrong": (wrong, 0),
                "pairing_disagree": (disagree, 0)}


class Control:
    """The reference's verdict in the exponent without the hash equation:
    a lane whose Z was moved is accepted."""

    def __init__(self, loop):
        self.loop = loop

    def verify_batch(self, vk, inputs_list, proofs) -> list:
        L = self.loop
        out = []
        for inputs, proof in zip(inputs_list, proofs):
            lane = L.by_id[(id(inputs), id(proof))]
            out.append(ref.verify_exponent(L.curve, L.td, lane.values,
                                           lane.logs, lane.points,
                                           hash_check=False))
        return out
