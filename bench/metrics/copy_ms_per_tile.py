"""Device milliseconds of host-to-device and device-to-host copies in
the traced window, over the tiles completed in it."""


def read(run):
    if run.device is None:
        return None
    done = run.done_between(run.device.start, run.device.end)
    secs = sum(e.dur for e in run.device.events
               if e.kind == "memcpy" and ("HtoD" in e.name or "DtoH" in e.name))
    return 1e3 * secs / done if done and secs > 0 else None
