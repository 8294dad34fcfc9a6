from lsdradixsort.bench.runner import run_suite, SUITES  # noqa: F401
