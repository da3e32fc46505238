"""The layered min-sum decoder kernel (``csrc/ldpc_minsum.cu``,
``ldpc_minsum_kernel``): one launch over every codeword of a replay,
filler lanes and padding slots included.  Bytes: the channel LLRs in and
the posteriors out (float32), one iteration count a codeword, for every
codeword launched; operations: ``arith.ldpc_flops`` at the iterations
each real codeword needs (a padding slot's are not counted, so the
least time is never too long)."""
from harness.arith import ldpc_flops

SYMBOL = "ldpc_minsum_kernel"


def launches(cell, rung, bucket) -> list:
    code = rung.code
    n_cw = bucket["lanes"] * bucket["batch"] * rung.codewords_per_slot
    nbytes = 2 * n_cw * code.n_mother * 4 + n_cw * 4
    return [(nbytes, ldpc_flops(bucket["real_iters"], code.n_edges,
                                code.z))]


def step_ops(cell, rung, bucket) -> float:
    code = rung.code
    return ldpc_flops(bucket["real_iters"], code.n_edges, code.z)
