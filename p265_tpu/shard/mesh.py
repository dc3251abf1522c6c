"""Device mesh + collective building blocks (SURVEY.md 2.3, 5).

Codec-native parallel axes mapped to mesh axes:
  'stream' -- independent bitstreams (data parallel, config 5)
  'space'  -- CTU-row blocks within a picture (halo-exchanged stencils,
              tiles/WPP recon sharding, config 4)

Collectives used: lax.ppermute for filter halos (<=4 px), psum for metrics;
DPB reference slabs all_gather lands with the inter milestone.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axes=("stream", "space")) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    a = 2 if n % 2 == 0 and n > 1 else 1
    b = n // a
    return Mesh(np.array(devs).reshape(a, b), axes)


def halo_exchange_rows(block: jnp.ndarray, halo: int, axis_name: str):
    """Within shard_map: exchange `halo` boundary rows with both row-neighbors.

    block: [rows_local, W].  Returns (top_halo, bottom_halo) received from the
    previous / next shard along `axis_name` (zeros at the picture edges).
    """
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    # send our TOP rows to the previous shard (they become its bottom halo)
    top_rows = block[:halo]
    bot_rows = block[-halo:]
    fwd = [(i, (i + 1) % n) for i in range(n)]   # i -> i+1
    bwd = [(i, (i - 1) % n) for i in range(n)]
    from_prev = jax.lax.ppermute(bot_rows, axis_name, fwd)   # prev's bottom
    from_next = jax.lax.ppermute(top_rows, axis_name, bwd)   # next's top
    zero = jnp.zeros_like(from_prev)
    top_halo = jnp.where(idx == 0, zero, from_prev)
    bot_halo = jnp.where(idx == n - 1, jnp.zeros_like(from_next), from_next)
    return top_halo, bot_halo


def sharded_stencil_step(mesh: Mesh, planes: jnp.ndarray) -> jnp.ndarray:
    """Demonstration/validation step for the multi-chip path: per-stream
    residual-transform compute + a vertical 3-tap stencil across row-shards
    with ppermute halo exchange + global psum checksum.  Used by
    the sharding tests.

    planes: [S, H, W] int32, S sharded over 'stream', H over 'space'.
    """
    from p265_tpu.tables import DCT8

    m = jnp.asarray(np.asarray(DCT8), jnp.int32)

    def step(local):  # [S_loc, H_loc, W]
        s, hl, wl = local.shape
        # matmul-shaped compute: 8x8 transform over row bands (exact int path)
        bands = local.reshape(s, hl // 8, 8, wl // 8, 8)
        bands = jnp.einsum("ij,shjwk->shiwk", m, bands,
                           preferred_element_type=jnp.int32) >> 6
        comp = bands.reshape(s, hl, wl)
        # halo-exchanged stencil along rows (per stream)
        def one(pl):  # [H_loc, W]
            top, bot = halo_exchange_rows(pl, 1, "space")
            ext = jnp.concatenate([top, pl, bot], axis=0)
            return (ext[:-2] + 2 * ext[1:-1] + ext[2:]) >> 2
        sten = jax.vmap(one)(comp)
        checksum = jax.lax.psum(jax.lax.psum(jnp.sum(sten), "space"), "stream")
        return sten + (checksum & 1)

    specs = P("stream", "space", None)
    fn = jax.shard_map(step, mesh=mesh, in_specs=(specs,), out_specs=specs)
    return jax.jit(fn)(planes)
