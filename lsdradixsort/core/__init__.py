from lsdradixsort.core import digits, datagen, timing, roofline  # noqa: F401
