"""The benchmark of ``autourdf_tpu_torch`` (the PyTorch and CUDA port) on one
NVIDIA H100: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  Nothing here imports ``jax`` or the JAX
package; the plain reference under ``reference/`` imports nothing of the
port either."""
