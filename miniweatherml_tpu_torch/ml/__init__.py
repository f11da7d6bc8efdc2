"""The ML-surrogate workflow: the MLP and its weight files (``mlp.py``),
training-data harvesting (``surrogate_data.py``) and offline training
(``train.py``).

Port of ``miniweatherml_tpu/ml/``.  The surrogate is a small dense MLP
applied per cell with ``torch.matmul`` inside the microphysics step
(``physics/kessler_surrogate.py``); the JAX package computes it with plain
``jnp`` matmuls too, outside any Pallas kernel.
"""
