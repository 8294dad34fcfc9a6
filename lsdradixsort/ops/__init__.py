from lsdradixsort.ops.sort import sort, sort_kv, argsort  # noqa: F401
from lsdradixsort.ops.filter import (filter_keys, filter_kv,  # noqa: F401
                                     filter_in_set, filter_not_in_set,
                                     compact)
from lsdradixsort.ops.aggregate import (group_by_sum, group_by_aggregate,  # noqa: F401
                                        filtered_group_by_sum)
from lsdradixsort.ops.join import (hash_join, hash_join_multi,  # noqa: F401
                                   probe_lookup, probe_lookup64,
                                   hash_join64)
from lsdradixsort.ops.topk import top_k, unique  # noqa: F401
from lsdradixsort.ops.window import window_rank  # noqa: F401
from lsdradixsort.ops.sort import (sort_with_ranks,  # noqa: F401
                                   sort64_with_ranks, sort_lex,
                                   sort_blocks_kv)
from lsdradixsort.ops.primitives import (digit_histogram,  # noqa: F401
                                         block_digit_histograms,
                                         exclusive_scan, block_prefix_sums,
                                         fill_forward_last)
