"""Predicted frames (videos x samples x predicted frames of every whole
batch in the window) over the window's time, host clock."""


def read(rec):
    if rec.kind != "eval" or not rec.window_s:
        return None
    return rec.frames / rec.window_s
