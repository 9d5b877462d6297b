"""The x-transformer mapper family (`model_type` "xtransformer"):
feed_forward_vqgan_clip's XTransformer, lucidrains' x-transformers 0.19.1
`ContinuousTransformerWrapper` around a `Decoder`, in its published key names.

z (B, input_dim) becomes S*S tokens by one of three input modes:

  * initial_proj: Linear(input_dim -> S*S*dim) reshaped to (S*S, dim);
  * add_input (and not initial_proj): z on every token;
  * neither: z as token 0 before S*S zero tokens, token 0 dropped at the end.

Then project_in, plus the learned absolute positions, `depth` pre-LN blocks
of causal multi-head attention (bias-free to_q, to_k, to_v of heads x 64,
scale 64**-0.5, to_out with a bias) and a feed-forward (Linear, exact GELU,
Linear at 4x the width), each added to the stream, the final LayerNorm and
project_out to the VQGAN's channels, read as (S, S, channels) row-major.

Departures from x-transformers 0.19.1: none in the arithmetic. Its causal
mask fills with -finfo(float32).max where this one fills with -inf; either
gives the masked scores a weight of exactly 0. Dropout is 0.
"""

import torch
import torch.nn.functional as F

from perfbench.reference import models as R
from perfbench.reference.precision import EXACT, Precision

DIM_HEAD = 64  # x-transformers' DEFAULT_DIM_HEAD, whatever dim is
FF_MULT = 4


def _modes(m):
    return bool(m.get("initial_proj", True)), bool(m.get("add_input", False))


def spec(m, clip_dim, channels):
    """The XTransformer's state dict in its key order: proj, project_in, the
    positions, per block the attention's LayerNorm, to_q, to_k, to_v, to_out,
    the feed-forward's LayerNorm, net.0.0, net.2, then norm and project_out."""
    d = m["dim"]
    n, inner = m["vq_image_size"] ** 2, m["num_heads"] * DIM_HEAD
    input_dim = clip_dim + m["noise_dim"]
    initial_proj, add_input = _modes(m)
    spec = {}
    if initial_proj:
        R._dense("proj.", n * d, input_dim, spec)
    R._dense("transformer.project_in.", d, d if initial_proj else input_dim, spec)
    # S*S + 1 rows unless add_input, in every mode (with initial_proj the last is unused)
    spec["transformer.pos_emb.emb.weight"] = ((n + (0 if add_input else 1), d), R._normal(1.0))
    for i in range(m["depth"]):
        p = f"transformer.attn_layers.layers.{2 * i}."
        R._norm_pair(p + "0.", d, spec)
        for name in ("to_q", "to_k", "to_v"):
            R._dense(p + f"1.{name}.", inner, d, spec, bias=False)
        R._dense(p + "1.to_out.", d, inner, spec)
        p = f"transformer.attn_layers.layers.{2 * i + 1}."
        R._norm_pair(p + "0.", d, spec)
        R._dense(p + "1.net.0.0.", FF_MULT * d, d, spec)
        R._dense(p + "1.net.2.", d, FF_MULT * d, spec)
    R._norm_pair("transformer.norm.", d, spec)
    R._dense("transformer.project_out.", channels, d, spec)
    return spec


def forward(sd, z, m, channels, P: Precision = EXACT):
    """(B, input_dim) -> (B, S, S, channels), as the module docstring says:
    attention as q k^T * 64**-0.5, the future masked, a float32 softmax and a
    product with v; every product through `P.q`."""
    with P.matmul_mode():
        s, d, heads = m["vq_image_size"], m["dim"], m["num_heads"]
        n, b = s * s, z.shape[0]
        initial_proj, add_input = _modes(m)
        z = z.float()
        if initial_proj:
            h = R.linear(z, sd["proj.weight"], sd["proj.bias"], P).reshape(b, n, d)
        elif add_input:
            h = z[:, None, :].expand(b, n, z.shape[1])
        else:
            h = torch.cat([z[:, None, :], z.new_zeros(b, n, z.shape[1])], dim=1)
        h = R.linear(h, sd["transformer.project_in.weight"], sd["transformer.project_in.bias"], P)
        t = h.shape[1]
        h = h + sd["transformer.pos_emb.emb.weight"][:t].float()
        future = torch.ones(t, t, dtype=torch.bool, device=h.device).triu(1)
        for i in range(m["depth"]):
            p = f"transformer.attn_layers.layers.{2 * i}."
            y = R.layer_norm(h, sd[p + "0.weight"], sd[p + "0.bias"])
            q, k, v = (R.linear(y, sd[p + f"1.{name}.weight"], None, P)
                       .reshape(b, t, heads, DIM_HEAD).transpose(1, 2)
                       for name in ("to_q", "to_k", "to_v"))
            dots = (P.q(q) @ P.q(k).transpose(-1, -2)) * DIM_HEAD ** -0.5
            att = torch.softmax(dots.masked_fill(future, float("-inf")), -1)
            o = (P.q(att) @ P.q(v)).transpose(1, 2).reshape(b, t, heads * DIM_HEAD)
            h = h + R.linear(o, sd[p + "1.to_out.weight"], sd[p + "1.to_out.bias"], P)
            p = f"transformer.attn_layers.layers.{2 * i + 1}."
            y = R.layer_norm(h, sd[p + "0.weight"], sd[p + "0.bias"])
            y = F.gelu(R.linear(y, sd[p + "1.net.0.0.weight"], sd[p + "1.net.0.0.bias"], P))
            h = h + R.linear(y, sd[p + "1.net.2.weight"], sd[p + "1.net.2.bias"], P)
        h = R.layer_norm(h, sd["transformer.norm.weight"], sd["transformer.norm.bias"])
        h = R.linear(h, sd["transformer.project_out.weight"], sd["transformer.project_out.bias"], P)
        if not initial_proj and not add_input:
            h = h[:, 1:]
        return h.reshape(b, s, s, channels)
