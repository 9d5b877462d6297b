"""The MLP-Mixer mapper family (`model_type` "mlp_mixer"): mlp_mixer_pytorch's
MLPMixer as feed_forward_vqgan_clip wraps it, in its published key names."""

import torch.nn.functional as F

from perfbench.reference import models as R
from perfbench.reference.precision import EXACT, Precision


def spec(m, clip_dim, channels):
    """mlp_mixer_pytorch's MLPMixer as feed_forward_vqgan_clip wraps it."""
    s, d, depth, ex = m["vq_image_size"], m["dim"], m["depth"], m["expansion"]
    t, spec = s * s, {}
    R._dense("proj.", t * channels, clip_dim + m["noise_dim"], spec)
    R._dense("mixer.1.", d, channels, spec)
    for i in range(depth):
        p = f"mixer.{2 + i}."
        R._norm_pair(p + "0.norm.", d, spec)
        R._dense(p + "0.fn.0.", t * ex, t, spec, extra=(1,))
        R._dense(p + "0.fn.3.", t, t * ex, spec, extra=(1,))
        R._norm_pair(p + "1.norm.", d, spec)
        R._dense(p + "1.fn.0.", d * ex, d, spec)
        R._dense(p + "1.fn.3.", d, d * ex, spec)
    R._norm_pair(f"mixer.{2 + depth}.", d, spec)
    R._dense("final_proj.", channels, d, spec)
    return spec


def forward(sd, x, m, channels, P: Precision = EXACT):
    """(B, input_dim) -> (B, S, S, channels): proj viewed channel-major as
    (B, channels, S, S) and read out as S*S tokens, Linear to dim, `depth`
    blocks of token mixing (size-1 Conv1d over tokens) and channel mixing, each
    pre-LN with exact GELU and a residual, a final LN and the projection back."""
    with P.matmul_mode():
        s, depth, b = m["vq_image_size"], m["depth"], x.shape[0]
        h = R.linear(x, sd["proj.weight"], sd["proj.bias"], P)
        h = h.reshape(b, channels, s, s).permute(0, 2, 3, 1).reshape(b, s * s, channels)
        h = R.linear(h, sd["mixer.1.weight"], sd["mixer.1.bias"], P)
        for i in range(depth):
            p = f"mixer.{2 + i}."
            y = R.layer_norm(h, sd[p + "0.norm.weight"], sd[p + "0.norm.bias"])
            y = P.q(sd[p + "0.fn.0.weight"][:, :, 0]) @ P.q(y) + sd[p + "0.fn.0.bias"][:, None]
            y = F.gelu(y)
            y = P.q(sd[p + "0.fn.3.weight"][:, :, 0]) @ P.q(y) + sd[p + "0.fn.3.bias"][:, None]
            h = h + y
            y = R.layer_norm(h, sd[p + "1.norm.weight"], sd[p + "1.norm.bias"])
            y = F.gelu(R.linear(y, sd[p + "1.fn.0.weight"], sd[p + "1.fn.0.bias"], P))
            h = h + R.linear(y, sd[p + "1.fn.3.weight"], sd[p + "1.fn.3.bias"], P)
        h = R.layer_norm(h, sd[f"mixer.{2 + depth}.weight"], sd[f"mixer.{2 + depth}.bias"])
        h = R.linear(h, sd["final_proj.weight"], sd["final_proj.bias"], P)
        return h.reshape(b, s, s, channels)
