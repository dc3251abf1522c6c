"""p265_tpu: a bit-exact HEVC (H.265) Main-profile decoder framework.

Architecture (SURVEY.md section 7): host-side CABAC/syntax parse (Stage A)
emits dense fixed-shape frame plans; batched JAX/Pallas kernels (Stage B)
reconstruct pictures on the device (GPU); sharding over jax.sharding.Mesh parallelizes
streams / frames / tiles / CTU rows with XLA collectives.
"""

__version__ = "0.1.0"
