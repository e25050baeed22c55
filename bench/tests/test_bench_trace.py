"""How the trace gives a range its device time."""

from bench import trace as tr


def trace_of(spans, kernels, cpu=()):
    t = tr.Trace.__new__(tr.Trace)
    t.gpu_ranges = {"bench.x": list(spans)} if spans else {}
    t.kernels = sorted(kernels)
    t.cpu = sorted(cpu)
    return t


def test_a_kernel_belongs_to_the_span_its_midpoint_lies_in():
    """A span whose end is rounded below its kernel's end keeps the
    kernel; the kernels between spans are not the range's."""
    t = trace_of([(100, 199), (300, 400)],
                 [(100, 200, "k", 1), (200, 300, "other", 2),
                  (300, 350, "k", 3), (350, 400, "k", 4)])
    assert t.range_time("bench.x") == (200 / 1e9, 3, 0)


def test_a_span_whose_kernels_were_lost_counts_its_own_length():
    t = trace_of([(100, 200), (300, 340)], [(100, 200, "k", 1)])
    assert t.range_time("bench.x") == (140 / 1e9, 1, 1)
    assert t.device_seconds("bench.x") == 140 / 1e9


def test_without_spans_the_launches_inside_the_range_count():
    """Where the profiler drew no device-side span, the kernels whose
    launch lies inside the range on the host, on its thread, are the
    range's."""
    cpu = [(0, 50, "bench.x", 7, 0, "range"),
           (10, 11, "cudaLaunchKernel", 7, 1, "launch"),
           (60, 61, "cudaLaunchKernel", 7, 2, "launch"),
           (20, 21, "cudaLaunchKernel", 8, 3, "launch")]
    t = trace_of([], [(100, 130, "k", 1), (130, 170, "k", 2),
                      (170, 190, "k", 3)], cpu)
    assert t.range_time("bench.x") == (30 / 1e9, 1, 0)
