"""Device-mesh sharded suffix arrays: multi-chip construction + queries.

Capability parity: this is the device-mesh form of the reference's rayon
thread-pool partitioned build (ref: crates/sacapart/src/lib.rs:45-51
`par_chunks`) and its query-side reduction (:86-92) — re-expressed as
`shard_map` over a `jax.sharding.Mesh`:

- the *text axis* is sharded ("parts"): one text partition per device,
  each device runs the full doubling SACA on its HBM-resident chunk —
  the sequence-parallel analog for this workload;
- the *query batch axis* ("batch") can be sharded too: needles split
  across that axis, every device answers for its needles against its
  partition;
- the reduction (best match over partitions, earliest partition wins
  ties) is an all-gather of per-partition candidates followed
  by a replicated argmax — the collective form of sacapart's
  first-wins max loop.

The full text stays replicated for the boundary-repair step, mirroring
the reference where partitioning affects *construction* while queries
read the whole text (crates/sacapart/src/lib.rs:69-97).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stringsearch_tpu.core import compare as cmp
from stringsearch_tpu.core.search import _ceil_log2, _needle_batch_to_windows, lcs_kernel
from stringsearch_tpu.core.types import BytesLike, LongestCommonSubstring, as_text_array

_I32 = jnp.int32


def make_mesh(
    n_devices: Optional[int] = None,
    batch_axis: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A ("parts", "batch") mesh over the given (or all) devices."""
    devs = list(devices) if devices is not None else list(jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n % batch_axis != 0:
        raise ValueError(f"{n} devices not divisible by batch_axis={batch_axis}")
    arr = np.array(devs).reshape(n // batch_axis, batch_axis)
    return Mesh(arr, ("parts", "batch"))


def _pad_to_partitions(text: jnp.ndarray, num_parts: int):
    n = int(text.shape[0])
    part = -(-max(n, num_parts) // num_parts)
    padded_len = part * num_parts
    if padded_len > n:
        text = jnp.concatenate([text, jnp.zeros((padded_len - n,), jnp.uint8)])
    real_lens = np.minimum(np.maximum(n - np.arange(num_parts) * part, 0), part)
    return text, part, np.asarray(real_lens, np.int32)


def build_sharded(text: BytesLike, mesh: Mesh):
    """Build per-partition SAs, one partition per "parts"-axis mesh slot.

    Returns (chunks [P, L] sharded, sas [P, L] sharded, real_lens [P]).
    """
    from functools import partial as _partial

    from stringsearch_tpu.engines.doubling import build_sa

    text = as_text_array(text)
    num_parts = mesh.shape["parts"]
    padded, part, real_lens = _pad_to_partitions(text, num_parts)
    chunks = padded.reshape(num_parts, part)
    chunk_sharding = NamedSharding(mesh, P("parts", None))
    chunks = jax.device_put(chunks, chunk_sharding)

    def per_shard(chunk):  # chunk: [parts_per_dev, L]
        # build_sa + adaptive=False: no ISA consumer, and vmapped
        # lax.switch would execute every cascade branch (see
        # partitioned.build_partitioned)
        return jax.vmap(_partial(build_sa, adaptive=False))(chunk)

    build = jax.jit(
        jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=P("parts", None),
            out_specs=P("parts", None),
            check_vma=False,
        )
    )
    sas = build(chunks)
    return chunks, sas, real_lens


@partial(jax.jit, static_argnames=("steps", "mesh"))
def _sharded_query(chunks, sas, full_text, real_lens, needles, steps: int, mesh: Mesh):
    """Sharded LCS query. needles [B, M] is sharded over "batch"; the
    candidate reduction all-gathers over "parts" inside shard_map."""

    def per_shard(chunk, sa, text, rlen, nds):
        # chunk/sa: [p_loc, L]; nds: [b_loc, M]; text replicated [n]
        part_idx = jax.lax.axis_index("parts")
        p_loc, chunk_len = chunk.shape
        starts, _ = jax.vmap(lambda c, s: lcs_kernel(c, s, nds, steps))(chunk, sa)
        # global coordinates + full-text repair (see parallel/partitioned.py)
        offs = (part_idx * p_loc + jnp.arange(p_loc, dtype=_I32))[:, None] * chunk_len
        gstarts = starts + offs
        valid = starts < rlen[:, None]
        windows = cmp.gather_window(text, gstarts, nds.shape[-1])
        tlen = cmp.prefix_match_len(windows, nds[None, :, :])
        tlen = jnp.where(valid, tlen, -1)  # [p_loc, b_loc]

        # reduce over partitions: all-gather candidates over the "parts"
        # axis, then a replicated argmax with earliest-partition ties
        all_len = jax.lax.all_gather(tlen, "parts", axis=0, tiled=True)  # [P, b_loc]
        all_start = jax.lax.all_gather(gstarts, "parts", axis=0, tiled=True)
        best_p = jnp.argmax(all_len, axis=0)
        best_len = jnp.maximum(jnp.max(all_len, axis=0), 0)
        best_start = jnp.take_along_axis(all_start, best_p[None, :], axis=0)[0]
        return best_start, best_len

    return jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(
            P("parts", None),
            P("parts", None),
            P(),
            P("parts"),
            P("batch", None),
        ),
        out_specs=(P("batch"), P("batch")),
        check_vma=False,
    )(chunks, sas, full_text, real_lens, needles)


class ShardedSuffixArray:
    """Mesh-sharded partitioned suffix array (multi-chip sacapart)."""

    def __init__(self, text: BytesLike, mesh: Mesh):
        self.mesh = mesh
        self.text = as_text_array(text)
        self.chunks, self.sas, real_lens = build_sharded(self.text, mesh)
        self.real_lens = jax.device_put(
            jnp.asarray(real_lens), NamedSharding(mesh, P("parts"))
        )
        self.partition_size = int(self.chunks.shape[1])
        self._host_text: Optional[np.ndarray] = None

    def num_partitions(self) -> int:
        return int(self.chunks.shape[0])

    def text_bytes(self) -> np.ndarray:
        if self._host_text is None:
            self._host_text = np.asarray(self.text)
        return self._host_text

    def longest_substring_match_batch(
        self, needles: Sequence[BytesLike]
    ) -> list[LongestCommonSubstring]:
        if not needles:
            return []
        batch_n = self.mesh.shape["batch"]
        padded, _lens, width = _needle_batch_to_windows(needles)
        # pad the batch to a multiple of the batch axis
        b = padded.shape[0]
        b_pad = -(-b // batch_n) * batch_n
        if b_pad > b:
            padded = np.concatenate(
                [padded, np.full((b_pad - b, width), cmp.PAST_NEEDLE_END, np.int32)]
            )
        needles_dev = jax.device_put(
            jnp.asarray(padded), NamedSharding(self.mesh, P("batch", None))
        )
        steps = _ceil_log2(self.partition_size + 1) + 1
        start, length = _sharded_query(
            self.chunks,
            self.sas,
            self.text,
            self.real_lens,
            needles_dev,
            steps,
            self.mesh,
        )
        start = np.asarray(start)[:b]
        length = np.asarray(length)[:b]
        host = self.text_bytes()
        return [
            LongestCommonSubstring(host, int(start[i]), int(length[i]))
            for i in range(b)
        ]

    def longest_substring_match(self, needle: BytesLike) -> LongestCommonSubstring:
        return self.longest_substring_match_batch([needle])[0]
