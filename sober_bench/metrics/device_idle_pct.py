"""device_idle_pct: the share of the profiled stretch of rounds in which no
kernel, copy or fill ran on the device (torch.profiler's trace; the stretch
adds no syncs and no sync debug mode)."""


def read(r):
    s = r.stretch
    if s is None or s.window_s <= 0 or s.n_device_events == 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
