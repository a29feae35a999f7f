"""ICL eval CLI: soft prompting or instruction tuning on k-shot genomic
prompts from a pretrained checkpoint (mirrors
`hyena_dna_tpu/evals/icl_cli.py`).

Runs on the card unless `--device cpu`; raises when there is no card.
Prints and returns {"mode", "dataset", "shots", "accuracy", "losses": the
loss of every tuning step}.

Usage:
  python -m hyena_dna_tpu_torch.evals.icl_cli --mode soft_prompting \
      --ckpt weights.pt --dest_path data/genomic_benchmark \
      --dataset_name human_nontata_promoters --shots 2 --steps 500
"""

from __future__ import annotations

import argparse
import json
import sys

from hyena_dna_tpu_torch.data.datamodules import ICLGenomicsDataModule
from hyena_dna_tpu_torch.evals.hg38_inference import build_model, load_params, resolve_device
from hyena_dna_tpu_torch.evals.instruction_tuned import instruction_tune
from hyena_dna_tpu_torch.evals.presets import apply_icl_preset, load_eval_preset
from hyena_dna_tpu_torch.evals.soft_prompting import evaluate_soft_prompt, tune_soft_prompt
from hyena_dna_tpu_torch.utils.numerics import set_card_numerics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default=None,
                    help="configs/evals yaml (e.g. soft_prompting_genomics) supplying mode "
                         "and tuning defaults; explicit flags win")
    ap.add_argument("--mode", choices=["soft_prompting", "instruction_tuned"],
                    default="soft_prompting")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--dest_path", required=True)
    ap.add_argument("--dataset_name", default="human_nontata_promoters")
    ap.add_argument("--shots", type=int, default=2)
    ap.add_argument("--max_length", type=int, default=256)
    ap.add_argument("--d_model", type=int, default=128)
    ap.add_argument("--n_layer", type=int, default=2)
    ap.add_argument("--n_soft", type=int, default=16)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    if args.preset:
        raw = argv if argv is not None else sys.argv[1:]
        explicit = {t.lstrip("-").split("=")[0] for t in raw if t.startswith("--")}
        apply_icl_preset(args, load_eval_preset(args.preset), explicit)
    device = resolve_device(args.device)
    set_card_numerics()

    dm = ICLGenomicsDataModule(dataset_name=args.dataset_name, dest_path=args.dest_path,
                               shots=args.shots, max_length=args.max_length, add_eos=True,
                               batch_size=args.batch_size)
    dm.setup()
    # prompt length: shots x classes x (seq + eos + label + eos) + test
    model = build_model(args.d_model, args.n_layer,
                        max_length=args.max_length * (2 * args.shots + 2))
    load_params(args.ckpt, model)
    model.to(device)
    if args.mode == "soft_prompting":
        _, predict, losses = tune_soft_prompt(model, dm.train_dataloader(), n_soft=args.n_soft,
                                              d_model=args.d_model, lr=args.lr or 1e-3,
                                              steps=args.steps)
    else:
        _, predict, losses = instruction_tune(model, dm.train_dataloader(),
                                              lr=args.lr or 1e-4, steps=args.steps)
    result = {"mode": args.mode, "dataset": args.dataset_name, "shots": args.shots,
              "accuracy": evaluate_soft_prompt(predict, dm.val_dataloader()),
              "losses": losses}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
