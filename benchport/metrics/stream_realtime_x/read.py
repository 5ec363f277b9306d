"""stream_realtime_x: audio seconds of the long streams decoded whole in
the window, over the time from the window's start to the last completion
(host clock; each decoder's construction included)."""


def read(run):
    if run.traffic["mode"] != "sharded" or run.win.seconds <= 0:
        return None
    return run.win.audio_s / run.win.seconds
