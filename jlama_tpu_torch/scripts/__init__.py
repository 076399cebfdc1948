"""Card benches of the port: counterparts of the JAX package's design benches
under `scripts/` (kbench_q4, kbench_w8a8, probe_int4, probe_sigma_i16), each
run with `python -m jlama_tpu_torch.scripts.<name>`."""
