"""Flagship benchmark: full-sort throughput on one card.

Prints ONE JSON line on stdout:
  {"metric": "sort_throughput", "value": <keys Melem/s>, "unit": "Melem/s",
   "kv_value": <stable kv Melem/s>, "n": 134217728, "platform": "gpu",
   "device_kind": "...", "device_count": 1, "card": "<name>, <power limit>"}

Workload: the reference's own flagship — sort uniform-random uint32 keys
(BenchmarkLSDRadixSort.md; the reference sorts keys-only) — plus the
north-star extension, the stable key-value sort (sort_with_ranks: the
keys with their row ids), both at 2^27 elements through the default path
(ops/sort.py). Each value is 2^27 over the median of 10 timed calls.

    python bench.py            # measure
    python bench.py --verify   # check both outputs against numpy first

Without a GPU it exits non-zero and prints no number.
"""
from __future__ import annotations

import json
import sys


def main() -> int:
    verify = "--verify" in sys.argv

    import jax
    import jax.numpy as jnp
    import numpy as np
    from lsdradixsort.core.cache import enable_persistent_cache
    from lsdradixsort.core.device import card_lines, require_gpu
    from lsdradixsort.core.timing import time_fn
    from lsdradixsort.ops.sort import sort, sort_with_ranks

    dev = require_gpu()
    enable_persistent_cache()
    n = 1 << 27
    keys = jax.random.bits(jax.random.PRNGKey(0), (n,), dtype=jnp.uint32)
    kfn = jax.jit(sort)
    rfn = jax.jit(sort_with_ranks)
    if verify:
        host = np.asarray(keys)
        perm = np.argsort(host, kind="stable")
        np.testing.assert_array_equal(np.asarray(kfn(keys)), host[perm])
        sk, sr = rfn(keys)
        np.testing.assert_array_equal(np.asarray(sk), host[perm])
        np.testing.assert_array_equal(np.asarray(sr), perm.astype(np.uint32))
        print("# verify: keys and stable kv bit-exact vs numpy",
              file=sys.stderr)
    tk = time_fn(kfn, keys, iters=10, warmup=2)
    tr = time_fn(rfn, keys, iters=10, warmup=2)
    rec = {"metric": "sort_throughput",
           "value": tk.gelems_per_s(n) * 1e3, "unit": "Melem/s",
           "kv_value": tr.gelems_per_s(n) * 1e3, "n": n,
           "platform": dev.platform, "device_kind": dev.device_kind,
           "device_count": len(jax.devices()), "card": card_lines()[0]}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
