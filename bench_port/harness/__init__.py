"""The benchmark's fixed machinery: name resolution, weights from the seed,
the window's statistics, the trace's reduction, the model's FLOPs and the
card's peaks. Cells, configurations, traffic mixes, metrics and kernels'
work counts are files of their own that this package finds by name."""
