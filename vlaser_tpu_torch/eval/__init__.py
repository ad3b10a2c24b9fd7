"""Benchmark evaluation of the port: copies of vlaser_tpu/eval's
framework-free modules that `scripts/eval_vlm.py` reaches (the generic and
embodied harnesses, the protocol runners and their metrics), the
closed-loop harnesses (`simpler_eval` with its fractal grids
`variant_configs`; `robotwin_eval`, whose policy runs the torch module)
and `llm_judge`, kept here so that nothing of the JAX package is imported.
Two edits in the copies: caption_metrics imports this package's
ptb_tokenizer, and vlm_benchmarks.load_jsonl_benchmark imports PIL only
for a row that names an image."""
