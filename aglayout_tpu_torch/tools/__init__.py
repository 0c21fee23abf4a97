"""Twins of the JAX package's root `tools/`, each run as `python -m
aglayout_tpu_torch.tools.<name>`: `import_reference_artifacts` (the
reference's vocab and co-occurrence matrix into a data directory),
`train_evidence` (thousands of train steps on the learnable synthetic-scene
corpus), `bench_train_table` (train-step throughput by size, batch and
dtype), `quality_curve` (the evaluation report on the live train state
every N steps) and `vg_scale_rehearsal` (corpus -> ETL -> co-occurrence ->
the training loop). Beside them, the port's own: `first_window`,
`compare_evidence`, `step_determinism`, `evidence_seeds` (the 128^2
evidence over four seeds and its rule), and `first_window_rule` with
`first_window_sets` (the 64^2 first window before and after the step's
capture as a CUDA graph, and its rule). h5py is imported inside the functions that need it;
the plots are drawn with PIL (`utils/plot.py`)."""
