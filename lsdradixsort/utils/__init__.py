from lsdradixsort.utils.verify import check_arrays, check_sorted  # noqa: F401
