"""CLI: the subcommands the port has so far.

`python -m feed_forward_vqgan_clip_tpu_torch.cli <command>`, the counterpart of
feed_forward_vqgan_clip_tpu/cli.py (dashes and underscores both accepted):

    train <config.yaml>                         train/loop.train
    test <model> <prompts> [--prior-path]       infer.test
    tokenize <file or glob> [--out]             data/tokenize_cli.tokenize
    encode-text-and-images <folder> [...]       data/encode.encode_text_and_images
    encode-text-and-images-webdataset <glob>    data/encode.encode_text_and_images_webdataset
    merge-features <shards...> --out <file>     data/encode.merge_features
    evaluate <model> <prompts> [...]            eval/evaluate.evaluate (CLIP score, FID)
    train-prior <config.yaml>                   train/prior.train_prior
    serve [model ...]                           serve/app.py (needs gradio)

A model is a `.th` file or a JAX checkpoint directory. The JAX package's
weight and bench subcommands are not registered (they need the network or
the benchmark). Every command that computes on a device runs on the card
unless `--device cpu` is given.
"""

import argparse
import logging


def _cmd_train(args):
    from feed_forward_vqgan_clip_tpu_torch.config import load_config
    from feed_forward_vqgan_clip_tpu_torch.train.loop import train

    train(load_config(args.config_file), device=args.device)


def _cmd_test(args):
    from feed_forward_vqgan_clip_tpu_torch.infer import test

    test(args.model_path, args.text_or_path, nb_repeats=args.nb_repeats,
         out_path=args.out_path, images_per_row=args.images_per_row,
         prior_path=args.prior_path, seed=args.seed, device=args.device)


def _cmd_tokenize(args):
    from feed_forward_vqgan_clip_tpu_torch.data.tokenize_cli import tokenize

    tokenize(args.paths, out=args.out, max_length=args.max_length, batch_size=args.batch_size)


def _cmd_encode(args):
    from feed_forward_vqgan_clip_tpu_torch.data.encode import encode_text_and_images

    encode_text_and_images(args.folder, img_ext=args.img_ext, text_ext=args.text_ext,
                           out=args.out, clip_model=args.clip_model, clip_path=args.clip_path,
                           device=args.device)


def _cmd_encode_wds(args):
    from feed_forward_vqgan_clip_tpu_torch.data.encode import (
        encode_text_and_images_webdataset,
    )

    encode_text_and_images_webdataset(
        args.pattern, clip_model=args.clip_model, clip_path=args.clip_path,
        batch_size=args.batch_size, img_col=args.img_col, txt_col=args.txt_col, out=args.out,
        image_quality_threshold=args.image_quality_threshold,
        image_quality_method=args.image_quality_method,
        nima_weights_path=args.nima_weights_path, merge=args.merge, device=args.device)


def _cmd_merge_features(args):
    from feed_forward_vqgan_clip_tpu_torch.data.encode import merge_features

    one = len(args.inputs) == 1 and any(ch in args.inputs[0] for ch in "*?[")
    merge_features(args.inputs[0] if one else args.inputs, args.out)


def _cmd_evaluate(args):
    from feed_forward_vqgan_clip_tpu_torch.eval.evaluate import evaluate

    evaluate(args.model_path, args.data_path, batch_size=args.batch_size,
             out_folder=args.out_folder, clip_threshold=args.clip_threshold,
             nb_test=args.nb_test, save_images=args.save_images, img_folder=args.img_folder,
             images_per_row=args.images_per_row, seed=args.seed, clip_model=args.clip_model,
             clip_model_path=args.clip_model_path, compute_fid=args.compute_fid,
             inception_features_real_path=args.inception_features_real_path,
             inception_weights_path=args.inception_weights_path, prior_path=args.prior_path,
             device=args.device)


def _cmd_train_prior(args):
    from feed_forward_vqgan_clip_tpu_torch.config import load_config
    from feed_forward_vqgan_clip_tpu_torch.train.prior import train_prior

    train_prior(load_config(args.config_file), device=args.device)


def _cmd_serve(args):
    from feed_forward_vqgan_clip_tpu_torch.serve.app import build_app

    build_app(args.model_paths or None, device=args.device).launch()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ffvc-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="train a mapper")
    t.add_argument("config_file")
    t.set_defaults(fn=_cmd_train)

    t = sub.add_parser("test", help="prompt(s) -> image grid")
    t.add_argument("model_path")
    t.add_argument("text_or_path")
    t.add_argument("--nb-repeats", type=int, default=1)
    t.add_argument("--out-path", default="gen.png")
    t.add_argument("--images-per-row", type=int, default=None)
    t.add_argument("--prior-path", default=None)
    t.add_argument("--seed", type=int, default=None)
    t.set_defaults(fn=_cmd_test)

    t = sub.add_parser("tokenize", help="texts -> token file")
    t.add_argument("paths")
    t.add_argument("--out", default="tokenized.npz")
    t.add_argument("--max-length", type=int, default=None)
    t.add_argument("--batch-size", type=int, default=None)
    t.set_defaults(fn=_cmd_tokenize)

    t = sub.add_parser("encode-text-and-images", aliases=["encode_text_and_images"],
                       help="(img, txt) folder -> CLIP feature pairs")
    t.add_argument("folder")
    t.add_argument("--img-ext", default="jpg")
    t.add_argument("--text-ext", default="txt")
    t.add_argument("--out", default="features.npz")
    t.add_argument("--clip-model", default="ViT-B/32")
    t.add_argument("--clip-path", default=None)
    t.set_defaults(fn=_cmd_encode)

    t = sub.add_parser("encode-text-and-images-webdataset",
                       aliases=["encode_text_and_images_webdataset"],
                       help="webdataset tars -> CLIP feature pairs")
    t.add_argument("pattern")
    t.add_argument("--clip-model", default="ViT-B/32")
    t.add_argument("--clip-path", default=None)
    t.add_argument("--batch-size", type=int, default=512)
    t.add_argument("--img-col", default="input.jpg")
    t.add_argument("--txt-col", default="output.txt")
    t.add_argument("--out", default="features.npz")
    t.add_argument("--image-quality-threshold", type=float, default=None)
    t.add_argument("--image-quality-method", default="nima")
    t.add_argument("--nima-weights-path", default=None, help="NIMA .pth (or $FFVC_NIMA_WEIGHTS)")
    t.add_argument("--merge", action="store_true")
    t.set_defaults(fn=_cmd_encode_wds)

    t = sub.add_parser("merge-features", aliases=["merge_features"],
                       help="concatenate per-process feature shards into one file")
    t.add_argument("inputs", nargs="+", help="shard paths or one glob pattern")
    t.add_argument("--out", required=True)
    t.set_defaults(fn=_cmd_merge_features)

    t = sub.add_parser("evaluate", help="CLIP score / FID over prompts")
    t.add_argument("model_path")
    t.add_argument("data_path")
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--out-folder", default=None)
    t.add_argument("--clip-threshold", type=float, default=25)
    t.add_argument("--nb-test", type=int, default=None)
    t.add_argument("--save-images", action="store_true")
    t.add_argument("--img-folder", default=None)
    t.add_argument("--images-per-row", type=int, default=8)
    t.add_argument("--seed", type=int, default=42)
    t.add_argument("--clip-model", default="ViT-B/32")
    t.add_argument("--clip-model-path", default=None, help="weights for the eval perceptor")
    t.add_argument("--compute-fid", action="store_true")
    t.add_argument("--inception-features-real-path", default=None)
    t.add_argument("--inception-weights-path", default=None)
    t.add_argument("--prior-path", default=None)
    t.set_defaults(fn=_cmd_evaluate)

    t = sub.add_parser("train-prior", aliases=["train_prior"], help="train the flow prior")
    t.add_argument("config_file")
    t.set_defaults(fn=_cmd_train_prior)

    t = sub.add_parser("serve", help="gradio web app over local checkpoints")
    t.add_argument("model_paths", nargs="*", help="mapper checkpoints (default: *.th here)")
    t.set_defaults(fn=_cmd_serve)

    for name in ("train", "test", "encode-text-and-images", "encode-text-and-images-webdataset",
                 "evaluate", "train-prior", "serve"):
        sub.choices[name].add_argument("--device", default="cuda",
                                       help="torch device (default: cuda)")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
