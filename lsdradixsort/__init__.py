"""lsdradixsort — a vectorized sort / query-execution engine in JAX.

A JAX/shard_map framework with the capabilities of the reference CUDA
benchmark program (emanuele-xyz/LSDRadixSort): an LSD radix sort built
from composable primitives — per-block digit histograms, exclusive
prefix sums, stable rank-and-scatter passes — extended into a columnar
query-execution operator set (sort, filter, hash aggregate, hash join)
that scales over a device mesh via psum'd global counts and all-to-all
shuffles.

Layer map (mirrors reference layering, SURVEY.md §1):
  core/      platform utils: digit math, data gen, timing, roofline table
  golden/    numpy oracle implementations (reference L3: LSDRadixSort.cu:25-139)
  ops/       jitted operators and the reference's primitives in plain
             JAX (reference L1/L2: LSDRadixSort.cu:141-910)
  parallel/  device-mesh distribution: psum counts, all-to-all shuffle
  bench/     benchmark harness + CLI (reference L4/L5: LSDRadixSort.cu:912-1185)
"""

from lsdradixsort.core import digits, datagen, timing, roofline
from lsdradixsort.ops.sort import (sort, sort_kv, argsort,
                                   sort_with_ranks, sort64_with_ranks, sort_lex,
                                   sort_blocks_kv)
from lsdradixsort.ops.filter import (filter_keys, filter_kv,
                                     filter_in_set, filter_not_in_set,
                                     compact)
from lsdradixsort.ops.aggregate import group_by_sum, group_by_aggregate
from lsdradixsort.ops.join import (hash_join, hash_join_multi,
                                   probe_lookup, probe_lookup64,
                                   hash_join64)
from lsdradixsort.ops.topk import top_k, unique
from lsdradixsort.ops.window import window_rank
from lsdradixsort.ops.primitives import (digit_histogram,
                                         block_digit_histograms,
                                         exclusive_scan, block_prefix_sums,
                                         fill_forward_last)

__version__ = "0.2.0"

__all__ = [
    "sort", "sort_kv", "argsort", "sort_with_ranks",
    "sort64_with_ranks", "sort_lex", "sort_blocks_kv",
    "fill_forward_last",
    "filter_keys", "filter_kv", "filter_in_set", "filter_not_in_set",
    "compact",
    "group_by_sum", "group_by_aggregate",
    "hash_join", "hash_join_multi", "probe_lookup", "probe_lookup64",
    "hash_join64", "top_k", "unique", "window_rank",
    "digit_histogram", "block_digit_histograms",
    "exclusive_scan", "block_prefix_sums",
    "digits", "datagen", "timing", "roofline",
]
