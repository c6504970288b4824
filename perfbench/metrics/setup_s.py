"""Seconds from process start to the window's start, warm-up included."""


def read(rec):
    return rec.setup_s
