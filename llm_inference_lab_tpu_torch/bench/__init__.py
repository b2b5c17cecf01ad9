"""The port's bench harness (port of llm_inference_lab_tpu/bench/): the
runner and baseline comparison (run_bench), the K sweep (k_sweep), the
long-run churn harness (stress) and the perplexity gate (quality_eval).
Library modules that the CLI calls; nothing here runs when imported."""
