"""Microbenchmarks of the candidate merge primitives on the local device:
sort, scatter-add, scatter-max, cumsum/nonzero at engine-relevant sizes."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from attpc_engine_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()


def timeit(label, fn, n=5):
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n
    print(f"{label}: {dt * 1000:.1f} ms", flush=True)
    return dt


def main():
    key = jax.random.PRNGKey(0)
    m = 20_000_000  # entries per batch (256 events x 768 pts x 100 px)
    img = 256 * 10240 * 512  # dense image cells (1.34G)

    keys = jax.random.randint(key, (m,), 0, img, dtype=jnp.int32)
    q = jax.random.uniform(key, (m,), dtype=jnp.float32)
    idx32 = jnp.arange(m, dtype=jnp.int32)

    # 2-operand sort at merge scale
    f_sort = jax.jit(lambda k, i: jax.lax.sort((k, i), dimension=0, num_keys=1))
    timeit("sort 20M (key,i32)", lambda: jax.block_until_ready(f_sort(keys, idx32)))

    # scatter-add into the dense image
    @jax.jit
    def scat_add(k, v):
        return jnp.zeros(img, jnp.float32).at[k].add(v)

    timeit("scatter-add 20M -> 1.34G", lambda: jax.block_until_ready(scat_add(keys, q)))

    # scatter-max (labels/last-writer)
    @jax.jit
    def scat_max(k, i):
        return jnp.zeros(img, jnp.int32).at[k].max(i)

    timeit("scatter-max 20M -> 1.34G", lambda: jax.block_until_ready(scat_max(keys, idx32)))

    # smaller image variant (64 events)
    img64 = 64 * 10240 * 512
    keys64 = keys % img64
    m5 = 5_000_000

    @jax.jit
    def scat_add64(k, v):
        return jnp.zeros(img64, jnp.float32).at[k].add(v)

    timeit(
        "scatter-add 5M -> 335M",
        lambda: jax.block_until_ready(scat_add64(keys64[:m5], q[:m5])),
    )

    # compaction: nonzero with static size over the dense image
    dense = scat_add64(keys64[:m5], q[:m5])

    @jax.jit
    def compact(d):
        (i,) = jnp.nonzero(d > 0, size=64 * 16384, fill_value=0)
        return i, d[i]

    timeit("nonzero+gather 335M -> 1M", lambda: jax.block_until_ready(compact(dense)))

    # cumsum at image scale (the nonzero building block)
    timeit("cumsum 335M u8->i32", lambda: jax.block_until_ready(
        jax.jit(lambda d: jnp.cumsum((d > 0).astype(jnp.int32)))(dense)
    ))


if __name__ == "__main__":
    main()
