"""Export a train checkpoint of the port into a weights-only serving
artifact (port of ``protein_redesign_tpu/cli/export_params.py``).

    python -m protein_redesign_tpu_torch.cli.export_params \\
        runs/exp/checkpoints exported/model [--step N] [--raw_weights]

A train checkpoint step carries Adam's state and both the trained and the
EMA weights; the export keeps the inference weights and the config
(``config.json`` + ``model.pt``, ``utils/weights.save_checkpoint``), loads
with every sampling CLI through ``-c exported/model`` and is the artifact
to copy between hosts. By default the lowest-val_loss step's EMA weights
are exported, as the reference predicts under EMA
(`ProteinReDiff/model.py:250-251`).
"""

from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("ckpt", type=Path, help="training checkpoints dir")
    parser.add_argument("out", type=Path, help="output export directory")
    parser.add_argument("--step", type=int, default=None,
                        help="checkpoint step (default: best val_loss, falling back to latest)")
    parser.add_argument("--raw_weights", action="store_true",
                        help="export raw params instead of EMA")
    args = parser.parse_args(argv)

    from ..utils.checkpoint import load_weights
    from ..utils.weights import save_checkpoint

    state_dict, cfg, step = load_weights(args.ckpt, step=args.step, raw=args.raw_weights)
    save_checkpoint(args.out, state_dict, cfg)
    print(
        f"exported step {step} "
        f"({'raw' if args.raw_weights else 'EMA'} weights) -> {args.out} "
        f"[single_dim={cfg.single_dim}, pair_dim={cfg.pair_dim}, "
        f"num_blocks={cfg.num_blocks}, num_steps={cfg.num_steps}]"
    )


if __name__ == "__main__":
    main()
