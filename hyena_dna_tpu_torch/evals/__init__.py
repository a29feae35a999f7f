"""Evaluation and serving entry points of the port: `hg38_inference`
(fixed-window perplexity), `hg38_inference_decoder` (a fine-tuned
classifier), `generate_cli` (full-forward and recurrent generation),
`icl_cli` (soft prompting and instruction tuning), and the presets of
`configs/evals/` (`presets`)."""

from hyena_dna_tpu_torch.evals.soft_prompting import SoftPromptModel, tune_soft_prompt

__all__ = ["SoftPromptModel", "tune_soft_prompt"]
