"""CLI: the subcommands the port has so far.

`python -m feed_forward_vqgan_clip_tpu_torch.cli <command>`, the counterpart of
feed_forward_vqgan_clip_tpu/cli.py (dashes and underscores both accepted):

    train <config.yaml>                         train/loop.train
    test <model.th> <prompts> [--prior-path]    infer.test
    evaluate <model.th> <prompts> [...]         eval/evaluate.evaluate (CLIP score, FID)
    train-prior <config.yaml>                   train/prior.train_prior
    serve [model.th ...]                        serve/app.py (needs gradio)

The JAX package's data-preparation, weight and bench subcommands are not
registered until they are ported (ROADMAP A16d, A16e). Every command runs on
the card unless `--device cpu` is given.
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

    for name in ("train", "test", "evaluate", "train-prior", "serve"):
        sub.choices[name].add_argument("--device", default="cuda",
                                       help="torch device (default: cuda)")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
