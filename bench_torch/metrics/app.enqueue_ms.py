"""app.enqueue_ms: the host's time to enqueue a frame, from the app's
PROFILER scope around it (`frame` in the host loop, `frame_loop` around a
run_on_device call), summed over the measured window and divided by its
frames. The scope never waits for the device, so this is enqueue time."""


def read(r):
    calls, ms = r.profiler_totals.get("frame" if r.host_loop else "frame_loop", (0, 0.0))
    if not calls or not r.window_frames:
        return None
    return ms / r.window_frames
