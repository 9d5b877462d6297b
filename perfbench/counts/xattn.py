"""Operations and bytes of one causal attention call, the x-transformer's
`F.scaled_dot_product_attention` (the program's `mapper.sdpa` span): the least
time behind `xattn_roofline`.

Causal, the scores and the weighted sum each take half of b·h·n²·d
multiply-adds: 2·b·h·n²·d operations in all (twice that without the mask).
Bytes: q, k, v read and o written once each, in the compute dtype (bf16).
"""

from perfbench.counts import flops as counts


def sdpa(batch: int, tokens: int, heads: int, dim_head: int, causal: bool = True):
    """(flops, bytes) of one attention call over `batch` rows of `tokens` tokens."""
    ops = (2 if causal else 4) * batch * heads * tokens * tokens * dim_head
    return ops, 4 * counts.BF16 * batch * heads * tokens * dim_head


def least_seconds(batch: int, tokens: int, heads: int, dim_head: int, causal: bool) -> float:
    """The least time of the call a `mapper.sdpa` span's attributes describe."""
    return counts.least_seconds(*sdpa(batch, tokens, heads, dim_head, causal))
