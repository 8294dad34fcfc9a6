from lsdradixsort.parallel.mesh import make_mesh, shard_1d  # noqa: F401
from lsdradixsort.parallel.dist_sort import dist_sort, dist_sort_kv  # noqa: F401
from lsdradixsort.parallel.dist_hist import dist_digit_histogram  # noqa: F401
from lsdradixsort.parallel.dist_query import (dist_group_by_sum,  # noqa: F401
                                              dist_join, dist_join_multi,
                                              dist_filter_kv, dist_top_k,
                                              dist_unique,
                                              undistribute)
