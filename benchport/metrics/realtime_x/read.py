"""realtime_x: all audio seconds of the fleets completed in the window,
over the time from the window's start to the last completion (host clock;
construction and the fetch to the host included)."""


def read(run):
    if run.traffic["mode"] != "fleet" or run.win.seconds <= 0:
        return None
    return run.win.audio_s / run.win.seconds
