"""The span readers (draw_ms, draw_launches_per_test, draw_idle_ms,
sw_kernel_roofline, plan_host_ms, idle_outside_ms) on a trace built by
hand, against arithmetic done by hand; each reads nothing where its span
is missing."""

import types

import pytest

from bench import harness, tracing

READERS = ("draw_ms", "draw_launches_per_test", "draw_idle_ms",
           "sw_kernel_roofline", "plan_host_ms", "idle_outside_ms")
BOUND_S = 1e-4          # the stand-in roofline's least time of one sweep
MAIN = 1                # the main host thread

# Two tests in a 1,000 us window. Test A: engine.run [10, 400], its plan
# [10, 30], its sweep [40, 390] in two chunks, each with a draw; test B:
# engine.run [500, 900], one chunk. Times in microseconds.
SPANS = [("bench.window", 0, 1000),
         ("engine.run", 10, 390), ("engine.plan", 10, 20),
         ("engine.sw", 40, 350), ("engine.sw_chunk", 40, 160),
         ("engine.draw", 45, 15), ("engine.sw_chunk", 200, 190),
         ("engine.draw", 205, 10),
         ("engine.run", 500, 400), ("engine.plan", 500, 20),
         ("engine.sw", 530, 350), ("engine.sw_chunk", 530, 350),
         ("engine.draw", 535, 15)]
# (launched at, device start, device end, correlation, category)
DEVICE = [(20, 25, 35, 1, "kernel"),         # in the plan: dm * dm
          (50, 52, 58, 2, "kernel"),         # draw A1
          (55, 58, 62, 3, "kernel"),         # draw A1
          (100, 62, 190, 4, "kernel"),       # s_W, chunk A1
          (210, 190, 195, 5, "kernel"),      # draw A2
          (220, 195, 380, 6, "kernel"),      # s_W, chunk A2
          (395, 385, 390, 7, "kernel"),      # F and p, in engine.run
          (450, 450, 452, 8, "kernel"),      # the harness, outside a run
          (540, 541, 545, 9, "kernel"),      # draw B
          (600, 600, 870, 10, "kernel"),     # s_W, chunk B
          (889, 890, 895, 11, "gpu_memcpy")]  # F to the host
UNLAUNCHED = (960, 970, 99)                  # a kernel with no launch seen


def events(spans=SPANS):
    ev = [("user_annotation", name, float(ts), float(dur), MAIN, 0)
          for name, ts, dur in spans]
    for at, a, b, corr, cat in DEVICE:
        ev.append(("cuda_runtime", "cudaLaunchKernel", float(at), 1.0, MAIN,
                   corr))
        ev.append((cat, f"k{corr}", float(a), float(b - a), 7, corr))
    a, b, corr = UNLAUNCHED
    ev.append(("kernel", "k99", float(a), float(b - a), 7, corr))
    return ev


def ctx(spans=SPANS, covariates=0):
    return types.SimpleNamespace(
        trace=tracing.Trace(events(spans)), tests=2,
        traffic={"covariates": covariates},
        roofline=types.SimpleNamespace(sw_labels_s=lambda n, p, g: BOUND_S),
        n=100, n_total=40, group_sizes=[50, 50])


def read(name, c):
    return harness.module("metrics", name).read(c)


def test_draw_ms():
    # draw kernels 2, 3, 5, 9: 6 + 4 + 5 + 4 us over 2 tests
    assert read("draw_ms", ctx()) == pytest.approx(19e-3 / 2)


def test_draw_launches_per_test():
    assert read("draw_launches_per_test", ctx()) == 4 / 2


def test_draw_idle_ms():
    # busy [25, 35], [52, 380], [385, 390], [450, 452], [541, 545],
    # [600, 870], [890, 895], [960, 970]; draws [45, 60] idle 7 us,
    # [205, 215] 0, [535, 550] 11
    assert read("draw_idle_ms", ctx()) == pytest.approx(18e-3 / 2)


def test_sw_kernel_roofline():
    # s_W kernels 4, 6, 10: 128 + 185 + 270 us
    assert read("sw_kernel_roofline", ctx()) == pytest.approx(
        100.0 * 2 * BOUND_S / 583e-6)


def test_plan_host_ms():
    assert read("plan_host_ms", ctx()) == pytest.approx(40e-3 / 2)


def test_idle_outside_ms():
    # outside the runs: [0, 10], [400, 500], [900, 1000] = 210 us, busy
    # 2 (kernel 8) + 10 (the unlaunched kernel)
    assert read("idle_outside_ms", ctx()) == pytest.approx(198e-3 / 2)


def test_draws_and_the_kernel_make_the_sweep():
    """draw_ms plus the sweep-kernel time behind sw_kernel_roofline is
    the device time of the kernels launched in engine.sw."""
    c = ctx()
    draw_s = read("draw_ms", c) * c.tests * 1e-3
    kernel_s = 100.0 * c.tests * BOUND_S / read("sw_kernel_roofline", c)
    assert draw_s + kernel_s == pytest.approx(c.trace.kernel_s_in("engine.sw"))


@pytest.mark.parametrize("missing,readers", [
    ("engine.draw", ("draw_ms", "draw_launches_per_test", "draw_idle_ms",
                     "sw_kernel_roofline")),
    ("engine.sw", ("sw_kernel_roofline",)),
    ("engine.plan", ("plan_host_ms",)),
    ("engine.run", ("idle_outside_ms",))])
def test_nothing_to_read_without_the_span(missing, readers):
    c = ctx([s for s in SPANS if s[0] != missing])
    for name in readers:
        assert read(name, c) is None, name
    for name in set(READERS) - set(readers):
        assert read(name, c) is not None, name


def test_a_program_without_the_spans_reads_nothing():
    """The parent's program marks only engine.sw: every new reader reads
    nothing and none raises."""
    c = ctx([s for s in SPANS if s[0] in ("bench.window", "engine.sw",
                                          "engine.sw_chunk")])
    for name in READERS:
        assert read(name, c) is None, name


def test_no_idle_without_a_card():
    """A CPU run's trace holds the spans but no device activity."""
    c = ctx()
    c.trace = tracing.Trace([e for e in events() if e[0] not in (
        "kernel", "gpu_memcpy")])
    for name in ("draw_idle_ms", "idle_outside_ms", "draw_ms",
                 "draw_launches_per_test", "sw_kernel_roofline"):
        assert read(name, c) is None, name
    assert read("plan_host_ms", c) == pytest.approx(40e-3 / 2)


def test_no_roofline_with_covariates():
    assert read("sw_kernel_roofline", ctx(covariates=2)) is None
