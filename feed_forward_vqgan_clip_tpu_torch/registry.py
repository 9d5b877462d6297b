"""Frozen-model constants the port reads: CLIP input sizes and embedding widths,
pixel normalisation, the CLIP ViT and ResNet architectures, the VQGAN decoder
configs, the released mapper and prior file names, and the URLs of the
released weights (download_weights.py).

The port's own copy of the entries it uses from feed_forward_vqgan_clip_tpu/
registry.py (the port imports nothing of the JAX package);
tests/test_torch_isolation.py holds the two equal.
"""

CLIP_SIZE = {
    "RN50": 224,
    "RN101": 224,
    "RN50x4": 288,
    "RN50x16": 384,
    "ViT-B/32": 224,
    "ViT-B/16": 224,
    "ViT-L/14": 224,
    "cloob_rn50": 224,
    "cloob_rn50x4": 288,
    "cloob_laion_400m_vit_b_16_32_epochs": 224,
    "openclip/ViT-B-32-quickgelu/laion400m_e32": 224,
    "openclip/ViT-B-32/laion2b_e16": 224,
    "tiny": 32,  # smoke/test preset
}

CLIP_DIM = {
    "RN50": 1024,
    "RN101": 512,
    "RN50x4": 640,
    "RN50x16": 768,
    "ViT-B/32": 512,
    "ViT-B/16": 512,
    "ViT-L/14": 768,
    "cloob_rn50": 1024,
    "cloob_rn50x4": 640,
    "cloob_laion_400m_vit_b_16_32_epochs": 512,
    "openclip/ViT-B-32-quickgelu/laion400m_e32": 512,
    "openclip/ViT-B-32/laion2b_e16": 512,
    "tiny": 32,
}

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# Public OpenAI CLIP ViT configs, plus the tiny smoke/test preset.
CLIP_VIT_CONFIGS = {
    "ViT-B/32": dict(
        image_size=224, patch_size=32, vision_width=768, vision_layers=12,
        vision_heads=12, embed_dim=512, text_width=512, text_layers=12,
        text_heads=8, vocab_size=49408, context_length=77,
    ),
    "ViT-B/16": dict(
        image_size=224, patch_size=16, vision_width=768, vision_layers=12,
        vision_heads=12, embed_dim=512, text_width=512, text_layers=12,
        text_heads=8, vocab_size=49408, context_length=77,
    ),
    "ViT-L/14": dict(
        image_size=224, patch_size=14, vision_width=1024, vision_layers=24,
        vision_heads=16, embed_dim=768, text_width=768, text_layers=12,
        text_heads=12, vocab_size=49408, context_length=77,
    ),
    "tiny": dict(
        image_size=32, patch_size=8, vision_width=64, vision_layers=2,
        vision_heads=2, embed_dim=32, text_width=32, text_layers=2,
        text_heads=2, vocab_size=49408, context_length=77,
    ),
}

# Public OpenAI CLIP ModifiedResNet configs (the ml-jku CLOOB RN50 / RN50x4 use
# RN50's and RN50x4's).
CLIP_RESNET_CONFIGS = {
    "RN50": dict(
        image_size=224, vision_layers=(3, 4, 6, 3), vision_width=64,
        embed_dim=1024, text_width=512, text_layers=12, text_heads=8,
        vocab_size=49408, context_length=77,
    ),
    "RN101": dict(
        image_size=224, vision_layers=(3, 4, 23, 3), vision_width=64,
        embed_dim=512, text_width=512, text_layers=12, text_heads=8,
        vocab_size=49408, context_length=77,
    ),
    "RN50x4": dict(
        image_size=288, vision_layers=(4, 6, 10, 6), vision_width=80,
        embed_dim=640, text_width=640, text_layers=12, text_heads=10,
        vocab_size=49408, context_length=77,
    ),
    "RN50x16": dict(
        image_size=384, vision_layers=(6, 8, 18, 8), vision_width=96,
        embed_dim=768, text_width=768, text_layers=12, text_heads=12,
        vocab_size=49408, context_length=77,
    ),
}

# taming-transformers `ddconfig` blocks of the public VQGAN releases.
VQGAN_CONFIGS = {
    "vqgan_imagenet_f16_16384": dict(
        n_embed=16384, embed_dim=256, z_channels=256, resolution=256,
        in_channels=3, out_ch=3, ch=128, ch_mult=(1, 1, 2, 2, 4),
        num_res_blocks=2, attn_resolutions=(16,), dropout=0.0,
    ),
    "vqgan_imagenet_f16_1024": dict(
        n_embed=1024, embed_dim=256, z_channels=256, resolution=256,
        in_channels=3, out_ch=3, ch=128, ch_mult=(1, 1, 2, 2, 4),
        num_res_blocks=2, attn_resolutions=(16,), dropout=0.0,
    ),
}

# The released mapper checkpoints' file names (the JAX registry's MODEL_URLS keys
# without the priors): the serving path's default model list, where present.
RELEASED_MODELS = (
    "cc12m_32x1024_vitgan_clip_ViTB32_256x256_v0.1.th",
    "cc12m_32x1024_vitgan_clip_ViTB32_256x256_v0.2.th",
    "cc12m_32x1024_mlp_mixer_clip_ViTB32_256x256_v0.2.th",
    "cc12m_32x1024_mlp_mixer_clip_ViTB32_256x256_v0.3.th",
    "cc12m_32x1024_mlp_mixer_cloob_rn50_256x256_v0.3.th",
    "cc12m_256x16_xtransformer_clip_ViTB32_512x512_v0.3.th",
    "cc12m_32x1024_mlp_mixer_clip_ViTB32_pixelrecons_256x256_v0.4.th",
    "cc12m_32x1024_mlp_mixer_openclip_laion2b_ViTB32_256x256_v0.4.th",
    "cc12m_32x1024_mlp_mixer_openclip_laion2b_imgEmb_ViTB32_256x256_v0.4.th",
    "cc12m_1x1024_mlp_mixer_openclip_laion2b_ViTB32_512x512_v0.4.th",
)

# The released flow priors (the JAX registry's `prior_*` MODEL_URLS keys).
PRIOR_FILES = (
    "prior_cc12m_2x1024_openclip_laion2b_ViTB32_v0.4.th",
    "prior_cc12m_2x1024_clip_ViTB32_v0.4.th",
)

# Mapper checkpoint -> its companion prior checkpoint: the serving path's default
# prior for each released mapper, where the file is present.
PRIOR_MODELS = {
    "cc12m_32x1024_vitgan_clip_ViTB32_256x256_v0.1.th": "prior_cc12m_2x1024_clip_ViTB32_v0.4.th",
    "cc12m_32x1024_vitgan_clip_ViTB32_256x256_v0.2.th": "prior_cc12m_2x1024_clip_ViTB32_v0.4.th",
    "cc12m_32x1024_mlp_mixer_clip_ViTB32_256x256_v0.2.th": "prior_cc12m_2x1024_clip_ViTB32_v0.4.th",
    "cc12m_32x1024_mlp_mixer_clip_ViTB32_256x256_v0.3.th": "prior_cc12m_2x1024_clip_ViTB32_v0.4.th",
    "cc12m_32x1024_mlp_mixer_cloob_rn50_256x256_v0.3.th": "prior_cc12m_2x1024_clip_ViTB32_v0.4.th",
    "cc12m_256x16_xtransformer_clip_ViTB32_512x512_v0.3.th": "prior_cc12m_2x1024_clip_ViTB32_v0.4.th",
    "cc12m_32x1024_mlp_mixer_clip_ViTB32_pixelrecons_256x256_v0.4.th": "prior_cc12m_2x1024_clip_ViTB32_v0.4.th",
    "cc12m_32x1024_mlp_mixer_openclip_laion2b_ViTB32_256x256_v0.4.th": "prior_cc12m_2x1024_openclip_laion2b_ViTB32_v0.4.th",
    "cc12m_32x1024_mlp_mixer_openclip_laion2b_imgEmb_ViTB32_256x256_v0.4.th": "prior_cc12m_2x1024_openclip_laion2b_ViTB32_v0.4.th",
    "cc12m_1x1024_mlp_mixer_openclip_laion2b_ViTB32_512x512_v0.4.th": "prior_cc12m_2x1024_openclip_laion2b_ViTB32_v0.4.th",
}

# Where the released weights are (download_weights.py): every mapper and prior
# file name above -> its release URL; the VQGAN f16-16384 config and checkpoint
# and the ml-jku CLOOB RN50 checkpoint; the CLIP BPE merge table.
_REL = "https://github.com/mehdidc/feed_forward_vqgan_clip/releases/download"

MODEL_URLS = {
    "cc12m_32x1024_vitgan_clip_ViTB32_256x256_v0.1.th": f"{_REL}/0.1/cc12m_32x1024.th",
    "cc12m_32x1024_vitgan_clip_ViTB32_256x256_v0.2.th": f"{_REL}/0.2/cc12m_32x1024_vitgan.th",
    "cc12m_32x1024_mlp_mixer_clip_ViTB32_256x256_v0.2.th": f"{_REL}/0.2/cc12m_32x1024_mlp_mixer.th",
    "cc12m_32x1024_mlp_mixer_clip_ViTB32_256x256_v0.3.th": f"{_REL}/0.3/cc12m_32x1024_mlp_mixer_clip_ViTB32_256x256_v0.3.th",
    "cc12m_32x1024_mlp_mixer_cloob_rn50_256x256_v0.3.th": f"{_REL}/0.3/cc12m_32x1024_mlp_mixer_cloob_rn50_256x256_v0.3.th",
    "cc12m_256x16_xtransformer_clip_ViTB32_512x512_v0.3.th": f"{_REL}/0.3/cc12m_256x16_xtransformer_clip_ViTB32_512x512_v0.3.th",
    "cc12m_32x1024_mlp_mixer_clip_ViTB32_pixelrecons_256x256_v0.4.th": f"{_REL}/0.4/cc12m_32x1024_mlp_mixer_clip_ViTB32_pixelrecons_256x256_v0.4.th",
    "cc12m_32x1024_mlp_mixer_openclip_laion2b_ViTB32_256x256_v0.4.th": f"{_REL}/0.4/cc12m_32x1024_mlp_mixer_openclip_laion2b_ViTB32_256x256_v0.4.th",
    "cc12m_32x1024_mlp_mixer_openclip_laion2b_imgEmb_ViTB32_256x256_v0.4.th": f"{_REL}/0.4/cc12m_32x1024_mlp_mixer_openclip_laion2b_imgEmb_ViTB32_256x256_v0.4.th",
    "cc12m_1x1024_mlp_mixer_openclip_laion2b_ViTB32_512x512_v0.4.th": f"{_REL}/0.4/cc12m_1x1024_mlp_mixer_openclip_laion2b_ViTB32_512x512_v0.4.th",
    "prior_cc12m_2x1024_openclip_laion2b_ViTB32_v0.4.th": f"{_REL}/0.4/prior_cc12m_2x1024_openclip_laion2b_ViTB32_v0.4.th",
    "prior_cc12m_2x1024_clip_ViTB32_v0.4.th": f"{_REL}/0.4/prior_cc12m_2x1024_clip_ViTB32_v0.4.th",
}

AUX_URLS = (
    f"{_REL}/0.1/vqgan_imagenet_f16_16384.yaml",
    f"{_REL}/0.1/vqgan_imagenet_f16_16384.ckpt",
    "https://ml.jku.at/research/CLOOB/downloads/checkpoints/cloob_rn50_yfcc_epoch_28.pt",
)

BPE_URL = "https://github.com/openai/CLIP/raw/main/clip/bpe_simple_vocab_16e6.txt.gz"
