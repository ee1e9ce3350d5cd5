"""The prove loop: one prover, its key resident, proves back to back (a
closed loop, one client).  Traffic: witness_pool, the satisfying
witnesses set-up makes from the seed, taken in turn so that a window's
proofs are each of another witness; trace_ops, the proofs of a traced
window.  Each proof gets 64 bytes of blinding of its own."""

from __future__ import annotations

from .. import circuit, programs, reference
from ..reference import groth16 as ref
from . import FAULT_TYPES, stream


def words(bits: int) -> int:
    """32-bit words of an element below 2^bits."""
    return -(-bits // 32)


class Blinding:
    """The bytes a prover draws for one proof, handed out in order."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def __call__(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("the prover asked for more than 64 random "
                             "bytes")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out


class Loop:
    kind = "prove"
    lanes = 1

    def __init__(self, cfg, traffic, seed, device, program=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.program = device, program
        self.curve = reference.curve(cfg["curve"])

    def prepare(self):
        r = self.curve.r
        self.circ = circuit.generate(self.cfg, self.seed, r)
        # one witness more than the window takes in turn: the warm proof's
        rng = stream(self.seed, "witness")
        self.pool = [circuit.witness(self.circ, rng)
                     for _ in range(self.traffic["witness_pool"] + 1)]
        n8 = words(r.bit_length()) * 4
        self.wbytes = [b"".join(v.to_bytes(n8, "little") for v in w)
                       for w in self.pool]
        self.prog = self.program(self) if self.program else \
            programs.PortProver(self.cfg["curve"], self.device)
        self.pkey = self.prog.setup(self.circ, self.seed)
        self.op(-1)

    def draw(self, i: int):
        """Operation i's witness (an index into the pool: the window's
        operations in turn, the warm operation -1 the last) and
        blinding."""
        n = self.traffic["witness_pool"]
        return (i % n if i >= 0 else n), stream(self.seed,
                                                f"op:{i}").randbytes(64)

    def op(self, i: int, timings=None):
        k, blind = self.draw(i)
        return self.prog.prove(self.wbytes[k], self.pkey, Blinding(blind),
                               timings), 1

    def sizes(self) -> dict:
        c = self.circ
        bits = sum(1 for kind, *_ in c.rows if kind in ("bool", "xor", "and"))
        nnz = [sum(len(row[m]) for row in c.constraints) for m in (0, 1)]
        return {"n_signals": c.n_signals, "n_public": c.n_public,
                "n_bits": bits, "n_wide": c.n_signals - bits,
                "domain": 1 << max(1, (len(c.constraints) + c.n_public)
                                   .bit_length()),
                "nnz_a": nnz[0] + c.n_public + 1, "nnz_b": nnz[1],
                "fq_words": words(self.curve.q.bit_length()),
                "fr_words": words(self.curve.r.bit_length()),
                "scalar_bits": self.curve.r.bit_length()}

    def release(self):
        """Drop the program, and with it its state on the device."""
        self.prog = None

    def check(self, ops) -> dict:
        """Every proof of the window against the one the reference works
        out for its witness and blinding (exact), and against the
        reference's verifying key by the pairing."""
        cv, r, n_pub = self.curve, self.curve.r, self.circ.n_public
        td = ref.Trapdoor.draw(self.seed, r)
        qap = ref.qap_at(self.circ.constraints, self.circ.n_signals, n_pub,
                         td.tau, r)
        kc = ref.private_coeffs(qap, td, r)
        vk = ref.verifying_key(cv, qap, td, n_pub)
        wrong = rejected = 0
        for op in ops:
            k, blind = self.draw(op.i)
            w = self.pool[k]
            want = ref.proof_json(cv, *ref.proof_scalars(
                qap, td, kc, w, n_pub, r, int.from_bytes(blind[:32], "little"),
                int.from_bytes(blind[32:], "little")))
            try:
                same = all(op.out[key] == want[key]
                           for key in ("pi_a", "pi_b", "pi_c"))
                ok = ref.verify_pairing(cv, vk, w[1:n_pub + 1], op.out)
            except FAULT_TYPES:
                same = ok = False
            wrong += not same
            rejected += not ok
        return {"proofs_wrong": (wrong, 0), "proofs_rejected": (rejected, 0)}


class Control:
    """The reference's prover with r = s = 0: zero knowledge broken, every
    proof still verifies."""

    def __init__(self, loop):
        self.loop = loop

    def setup(self, circ, seed):
        cv = self.loop.curve
        self.td = ref.Trapdoor.draw(seed, cv.r)
        self.qap = ref.qap_at(circ.constraints, circ.n_signals,
                              circ.n_public, self.td.tau, cv.r)
        self.kc = ref.private_coeffs(self.qap, self.td, cv.r)
        return b""

    def witness(self, wbytes: bytes) -> list:
        n8 = words(self.loop.curve.r.bit_length()) * 4
        return [int.from_bytes(wbytes[k:k + n8], "little")
                for k in range(0, len(wbytes), n8)]

    def prove(self, witness: bytes, pkey, rng, timings=None) -> dict:
        cv = self.loop.curve
        return ref.proof_json(cv, *ref.proof_scalars(
            self.qap, self.td, self.kc, self.witness(witness),
            self.loop.circ.n_public, cv.r, 0, 0))
