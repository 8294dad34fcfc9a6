from lsdradixsort.bench.runner import main

main()
