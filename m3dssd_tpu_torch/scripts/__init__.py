"""The port's command-line entry points: `python -m
m3dssd_tpu_torch.scripts.<train|test|export_model|eval_trajectory|
watch_eval|setup_split>`. Each that computes runs on the card unless
given `--cpu`, and keeps its work in a function that `main()` calls."""
