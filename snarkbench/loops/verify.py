"""The verify loop: one verifier takes batches of proofs against one key
back to back.  Traffic: batch, the lanes of a batch; batches, how many
distinct batches of valid proofs the window takes in turn (set-up makes
one more for the warm operation); bases, the proofs simulated in full
from which the others are derived; tampered, the lanes of each kind a
batch holds in seed-drawn places; pairing_sample, the lanes the
reference's pairing verifies after the window; trace_ops."""

from __future__ import annotations

import dataclasses

from .. import circuit, programs, reference
from ..reference import groth16 as ref
from . import FAULT_TYPES, stream


@dataclasses.dataclass
class Lane:
    inputs: list      # decimal strings, as the verifier takes them
    proof: dict
    values: list      # the inputs as integers
    logs: tuple       # (a, b, c): the proof points' discrete logs


class Loop:
    kind = "verify"

    def __init__(self, cfg, traffic, seed, device, program=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.program = device, program
        self.curve = reference.curve(cfg["curve"])
        self.lanes = traffic["batch"]
        self._want: dict = {}

    def prepare(self):
        cv, r = self.curve, self.curve.r
        circ = circuit.generate(self.cfg, self.seed, r)
        self.n_public = circ.n_public
        self.td = ref.Trapdoor.draw(self.seed, r)
        qap = ref.qap_at(circ.constraints, circ.n_signals, circ.n_public,
                         self.td.tau, r)
        self.vk = ref.verifying_key(cv, qap, self.td, circ.n_public)
        self.vk_json = ref.vk_json(cv, self.vk, circ.n_public)
        self.pool = self._pool(stream(self.seed, "pool"))
        rng = stream(self.seed, "tampered")
        self.bank = {kind: [self._tamper(kind, rng) for _ in range(4 * n)]
                     for kind, n in self.traffic["tampered"].items()}
        self.by_id = {(id(lane.inputs), id(lane.proof)): lane
                      for lane in self.pool + sum(self.bank.values(), [])}
        self.prog = self.program(self) if self.program else \
            programs.PortVerifier(self.cfg["curve"], self.device)
        self.op(-1)

    def _draw_inputs(self, rng) -> list:
        r = self.curve.r
        return [rng.randrange(r) if p["bits"] is None else
                rng.getrandbits(p["bits"]) if p["bits"] else 0
                for p in self.cfg["public_inputs"]]

    def _lane(self, values, a, b, c, proof=None) -> Lane:
        return Lane([str(v) for v in values],
                    proof or ref.proof_json(self.curve, a, b, c),
                    values, (a, b, c))

    def _c(self, values, a: int, b: int) -> int:
        """C's discrete log for these inputs, A and B: the verification
        equation solved with the setup's trapdoor."""
        td, r = self.td, self.curve.r
        x = (self.vk.ic_scalars[0] + sum(
            v * k for v, k in zip(values, self.vk.ic_scalars[1:]))) % r
        return (a * b - td.alpha * td.beta - x * td.gamma) \
            * pow(td.delta, -1, r) % r

    def _pool(self, rng) -> list:
        """(batches + 1) x batch valid proofs, every one with inputs of its
        own and A, B and C unlike any other's.  The bases are simulated in
        full: A and B at random, C from the equation.  Lane j of base k
        adds u G1 to A and v G2 to B, with (k, u) and (k, v) each used
        once (a table's add where a full product takes 32 of them), and
        C is worked out again."""
        cv, r, t = self.curve, self.curve.r, self.traffic
        n = (t["batches"] + 1) * t["batch"]
        k = t["bases"]
        per = -(-n // k)
        if per > 255:
            raise ValueError("bases too few for a pool of this depth")
        bases = []
        for _ in range(k):
            a, b = rng.randrange(1, r), rng.randrange(1, r)
            bases.append((a, b, cv.g1_mul(a), cv.g2_mul(b),
                          rng.sample(range(1, 256), per),
                          rng.sample(range(1, 256), per)))
        t1, t2 = cv.g1_table.table[0], cv.g2_table.table[0]
        pool = []
        for j in range(n):
            a0, b0, A0, B0, us, vs = bases[j % k]
            u, v = us[j // k], vs[j // k]
            values = self._draw_inputs(rng)
            a, b = (a0 + u) % r, (b0 + v) % r
            c = self._c(values, a, b)
            proof = {"pi_a": ref.g1_json(cv, cv.G1.add(A0, t1[u])),
                     "pi_b": ref.g2_json(cv, cv.G2.add(B0, t2[v])),
                     "pi_c": ref.g1_json(cv, cv.g1_mul(c)),
                     "protocol": "groth"}
            pool.append(self._lane(values, a, b, c, proof))
        return pool

    def _tamper(self, kind: str, rng) -> Lane:
        """A pool lane with one change: "point" moves A, B or C by the
        generator, "input" adds 1 to one input, "noncanonical" adds r to
        one (the same value mod r, which a verifier must refuse)."""
        r = self.curve.r
        base = self.pool[rng.randrange(len(self.pool))]
        values, (a, b, c) = list(base.values), base.logs
        if kind == "point":
            which = rng.randrange(3)
            a, b, c = ((a + (which == 0)) % r, (b + (which == 1)) % r,
                       (c + (which == 2)) % r)
            return self._lane(values, a, b, c)
        j = rng.randrange(len(values))
        values[j] = (values[j] + 1) % r if kind == "input" else values[j] + r
        return self._lane(values, a, b, c, proof=base.proof)

    def batch(self, i: int) -> list:
        """Operation i's lanes: ("pool", j) or (kind, j) into the bank.
        The window's operations take the pool's first `batches` slices in
        turn, the warm operation -1 the last slice; the tampered lanes
        take seed-drawn places."""
        rng = stream(self.seed, f"batch:{i}")
        n, m = self.traffic["batch"], self.traffic["batches"]
        s = i % m if i >= 0 else m
        refs = [("pool", s * n + j) for j in range(n)]
        kinds = [kind for kind, k in self.traffic["tampered"].items()
                 for _ in range(k)]
        for pos, kind in zip(rng.sample(range(n), len(kinds)), kinds):
            refs[pos] = (kind, rng.randrange(len(self.bank[kind])))
        return refs

    def lane(self, ref_) -> Lane:
        kind, j = ref_
        return self.pool[j] if kind == "pool" else self.bank[kind][j]

    def op(self, i: int, timings=None):
        lanes = [self.lane(x) for x in self.batch(i)]
        return self.prog.verify_batch(
            self.vk_json, [ln.inputs for ln in lanes],
            [ln.proof for ln in lanes]), len(lanes)

    def expected(self, ref_) -> bool:
        """The reference's verdict on a lane: the equation in the exponent,
        with the inputs checked."""
        if ref_ not in self._want:
            ln = self.lane(ref_)
            self._want[ref_] = ref.verify_exponent(
                self.td, self.vk.ic_scalars, ln.values, *ln.logs,
                self.curve.r)
        return self._want[ref_]

    def sizes(self) -> dict:
        return {"curve": self.cfg["curve"], "n_public": self.n_public,
                "fq_words": -(-self.curve.q.bit_length() // 32)}

    def release(self):
        """Drop the program, and with it its state on the device."""
        self.prog = None

    def check(self, ops) -> dict:
        """Every verdict of the window against the reference's, and a
        sample of lanes drawn from the seed, half of them tampered where
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
        bad = [s for s in seen if s[0][0] != "pool"]
        good = [s for s in seen if s[0][0] == "pool"]
        pick = rng.sample(bad, min(len(bad), n // 2))
        pick += rng.sample(good, min(len(good), n - len(pick)))
        disagree = 0
        for x, v in pick:
            ln = self.lane(x)
            try:
                ok = ref.verify_pairing(self.curve, self.vk, ln.inputs,
                                        ln.proof)
            except FAULT_TYPES:
                ok = None
            disagree += ok is None or ok != v or ok != self.expected(x)
        return {"verdicts_wrong": (wrong, 0),
                "pairing_disagree": (disagree, 0)}


class Control:
    """The reference's verdict in the exponent without the check that each
    input is below r: a lane whose input was raised by r is accepted."""

    def __init__(self, loop):
        self.loop = loop

    def verify_batch(self, vk, inputs_list, proofs) -> list:
        L = self.loop
        out = []
        for inputs, proof in zip(inputs_list, proofs):
            lane = L.by_id[(id(inputs), id(proof))]
            out.append(ref.verify_exponent(
                L.td, L.vk.ic_scalars, lane.values, *lane.logs, L.curve.r,
                check_range=False))
        return out
