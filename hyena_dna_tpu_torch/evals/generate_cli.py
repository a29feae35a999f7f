"""Sampling CLI: generate nucleotide sequences from a checkpoint (mirrors
`hyena_dna_tpu/evals/generate_cli.py`).

By default every new token is one full forward over the buffer
(`generation.py`: kernels A and B in each layer on the card); with
`--recurrent` the model is distilled into `--n_modes` modes per channel
(`recurrent.py::distill`, on the host) and decoded one O(1) step a token
after a parallel prefill of the prompt. Runs on the card unless
`--device cpu`; raises when there is no card. Prints the decoded text
(special and padded-vocabulary ids dropped) and returns {"text", "ids":
the prompt and new token ids, "seconds": the generation's wall time ending
in a device sync, "distill_seconds" (with `--recurrent`)}.

Usage:
  python -m hyena_dna_tpu_torch.evals.generate_cli --ckpt weights.pt \
      --prompt ACGTACGT --max_new_tokens 64 --temperature 0.8 --top_k 4
"""

from __future__ import annotations

import argparse
import time

import torch

from hyena_dna_tpu_torch.data.tokenizer import CharacterTokenizer
from hyena_dna_tpu_torch.evals.hg38_inference import build_model, load_params, resolve_device
from hyena_dna_tpu_torch.generation import generate
from hyena_dna_tpu_torch.utils.numerics import set_card_numerics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--prompt", default="ACGT")
    ap.add_argument("--max_new_tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top_k", type=int, default=None)
    ap.add_argument("--top_p", type=float, default=None)
    ap.add_argument("--d_model", type=int, default=128)
    ap.add_argument("--n_layer", type=int, default=2)
    ap.add_argument("--max_length", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--recurrent", action="store_true",
                    help="the modal-distilled O(1)-per-token stepper (recurrent.py) "
                         "instead of a full forward per token")
    ap.add_argument("--n_modes", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_card_numerics()

    tok = CharacterTokenizer(model_max_length=args.max_length + 2)
    model = build_model(args.d_model, args.n_layer, args.max_length)
    load_params(args.ckpt, model)
    model.to(device).eval()
    prompt = torch.as_tensor(tok.encode(args.prompt), dtype=torch.long, device=device)[None]
    generator = torch.Generator(device=device).manual_seed(args.seed)
    result = {}
    if args.recurrent:
        from hyena_dna_tpu_torch.recurrent import distill

        t0 = time.perf_counter()
        rec = distill(model, n_modes=args.n_modes)
        result["distill_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if args.recurrent:
        out = rec.generate(prompt, args.max_new_tokens,
                           generator=generator if args.temperature != 0 else None,
                           temperature=args.temperature, top_k=args.top_k)
    else:
        out = generate(model, prompt, args.max_new_tokens, generator=generator,
                       temperature=args.temperature, top_k=args.top_k, top_p=args.top_p)
    ids = out[0].cpu()  # the copy waits for the device
    result["seconds"] = time.perf_counter() - t0
    result["text"] = tok.decode(ids.numpy())
    result["ids"] = ids.tolist()
    print(result["text"])
    return result


if __name__ == "__main__":
    main()
