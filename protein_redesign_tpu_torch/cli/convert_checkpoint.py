"""Convert a reference PyTorch Lightning checkpoint (e.g. PRD_ver1.ckpt)
into the port's weights-only export (port of
``protein_redesign_tpu/cli/convert_checkpoint.py``).

    python -m protein_redesign_tpu_torch.cli.convert_checkpoint \\
        PRD_ver1.ckpt converted/PRD_ver1 [--use_ema/--no-use_ema]

The export (``config.json`` + ``model.pt``) loads with every sampling CLI
through ``-c converted/PRD_ver1``. The EMA (shadow) weights are used by
default, as the reference predicts under EMA (`model.py:250-251`); a
checkpoint without them gives its trained weights.
"""

from __future__ import annotations

from argparse import ArgumentParser, BooleanOptionalAction
from pathlib import Path


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("ckpt", type=Path, help="reference .ckpt path")
    parser.add_argument("out", type=Path, help="output export directory")
    parser.add_argument("--use_ema", action=BooleanOptionalAction, default=True)
    args = parser.parse_args(argv)

    from ..utils.weights import load_reference_weights, save_checkpoint

    state_dict, cfg, which = load_reference_weights(args.ckpt, use_ema=args.use_ema)
    save_checkpoint(args.out, state_dict, cfg)
    print(
        f"converted {args.ckpt} ({which} weights) -> {args.out} "
        f"[single_dim={cfg.single_dim}, pair_dim={cfg.pair_dim}, "
        f"num_blocks={cfg.num_blocks}]"
    )


if __name__ == "__main__":
    main()
