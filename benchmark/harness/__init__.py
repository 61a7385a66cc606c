"""The benchmark's own code: where cells, configurations, model families
and metrics are found (`spec`), the seeding of weights (`weights`),
traffic (`traffic`), the statistics (`stats`), the peaks (`roofline`),
spans and the profiler window (`trace`), the output check (`check`) and
one run of one cell (`runner`).  What is particular to an architecture
(its sizes, weights, engine, reference and work counts) is its family's,
under `benchmark/families/`.  None of it imports the program at module
level; the families and the drivers import `llama3np_tpu_torch` when a
run starts."""
