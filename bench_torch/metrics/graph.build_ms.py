"""graph.build_ms: the host's time in the app's `build_graph` scope (the
frame graph recorded anew), summed over the measured window and divided by
its frames."""


def read(r):
    calls, ms = r.profiler_totals.get("build_graph", (0, 0.0))
    if not calls or not r.window_frames:
        return None
    return ms / r.window_frames
