"""The VitGAN mapper family (`model_type` "vitgan"): the Generator of
feed_forward_vqgan_clip, in its published key names."""

import torch
import torch.nn.functional as F

from perfbench.reference import models as R
from perfbench.reference.precision import EXACT, Precision


def spec(m, clip_dim, channels):
    """The VitGAN Generator (scalar-gamma SLN, '(d k h)' packed qkv)."""
    d, heads = m["dim"], m["num_heads"]
    t, inner, spec = (m["vq_image_size"] // 8) * 8, heads * (m["dim"] // m["num_heads"]), {}
    spec["pos_emb1D"] = ((t, d), R._normal(1.0))
    R._dense("mlp.", t * d, clip_dim + m["noise_dim"], spec)

    def sln(p):  # scalar gain and shift, drawn as a norm's scale and shift are
        spec[p + "gamma"] = ((1, 1, 1), ("normal1", 0.02))
        spec[p + "beta"] = ((1, 1, 1), R.BIAS)
        R._norm_pair(p + "ln.", d, spec)

    for i in range(m["depth"]):
        p = f"Transformer_Encoder.blocks.{i}."
        sln(p + "norm1.")
        R._dense(p + "attn.to_qkv.", 3 * inner, d, spec, bias=False)
        R._dense(p + "attn.w_out.", d, inner, spec)
        sln(p + "norm2.")
        R._dense(p + "mlp.linear1.", 4 * d, d, spec)
        R._dense(p + "mlp.linear2.", d, 4 * d, spec)
    sln("sln_norm.")
    R._dense("w_out.0.", t * channels, d, spec)
    return spec


def forward(sd, z, m, channels, P: Precision = EXACT):
    """(B, input_dim) -> (B, T, T, channels), T = (S // 8) * 8 tokens: the
    modulation input x = mlp(z), per block hl += attn(SLN(hl, x)) and
    hl += mlp(SLN(hl, x)) with SLN(h, x) = gamma * x * LN(h) + beta * x
    (scalar gamma, beta), attention over the '(d k h)'-packed qkv scaled by
    dim**-0.5, the head on SLN(hl, x) viewed channel-major."""
    with P.matmul_mode():
        d, heads, b = m["dim"], m["num_heads"], z.shape[0]
        t = (m["vq_image_size"] // 8) * 8
        dh = d // heads
        x = R.linear(z, sd["mlp.weight"], sd["mlp.bias"], P).reshape(b, t, d)
        hl = sd["pos_emb1D"].float().expand(b, t, d)

        def sln(p, h):
            ln = R.layer_norm(h, sd[p + "ln.weight"], sd[p + "ln.bias"])
            return sd[p + "gamma"].float() * x * ln + sd[p + "beta"].float() * x

        for i in range(m["depth"]):
            p = f"Transformer_Encoder.blocks.{i}."
            qkv = R.linear(sln(p + "norm1.", hl), sd[p + "attn.to_qkv.weight"], None, P)
            qkv = qkv.reshape(b, t, dh, 3, heads).permute(3, 0, 4, 1, 2)
            q, k, v = qkv[0], qkv[1], qkv[2]
            att = torch.softmax(P.q(q) @ P.q(k).transpose(-1, -2) * d ** -0.5, -1)
            o = (P.q(att) @ P.q(v)).transpose(1, 2).reshape(b, t, heads * dh)
            hl = hl + R.linear(o, sd[p + "attn.w_out.weight"], sd[p + "attn.w_out.bias"], P)
            y = F.gelu(R.linear(sln(p + "norm2.", hl), sd[p + "mlp.linear1.weight"],
                                sd[p + "mlp.linear1.bias"], P))
            hl = hl + R.linear(y, sd[p + "mlp.linear2.weight"], sd[p + "mlp.linear2.bias"], P)
        out = R.linear(sln("sln_norm.", hl), sd["w_out.0.weight"], sd["w_out.0.bias"], P)
        return out.reshape(b, channels, t, t).permute(0, 2, 3, 1)
