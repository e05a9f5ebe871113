"""The port's command-line entry points: `python -m
m3dssd_tpu_torch.scripts.<train|test|export_model|eval_trajectory|
watch_eval|setup_split|convergence_check|learn_probe|serve_check|
eval_fallback_bench>`. Each that computes on a model runs on the card
unless given `--cpu`, and keeps its work in a function that `main()`
calls; eval_fallback_bench runs on the host alone."""
