"""gemm_ms_per_ktok: device ms of the GEMM kernels (names holding
``gemm``) launched inside the traced prefills, per 1000 prompt tokens."""

from portbench.tracing import kernels_within, spans_named


def read(records):
    trace = records["trace"]
    pre = spans_named(trace, "prefill")
    tokens = sum(a["batch"] * a["prompt"] for _, _, a in pre)
    ns = sum(e - s for n, s, e in kernels_within(trace, pre)
             if "gemm" in n.lower())
    if not tokens or not ns:
        return None
    return ns / 1e6 / (tokens / 1000.0)
