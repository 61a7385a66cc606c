"""The benchmark's own code: where cells, configurations and metrics are
found (`spec`), the seeded weights (`weights`), traffic (`traffic`), the
statistics (`stats`), the peaks and the operation and byte counts
(`roofline`), spans and the profiler window (`trace`), the output check
(`check`) and one run of one cell (`runner`).  None of it imports the
program at module level; `runner` and the drivers import
`llama3np_tpu_torch` when a run starts."""
