"""Tokens generated by every agent (rivers and side agents; not prompt
tokens fed through) and delivered within the window, over the window's
wall seconds."""


def read(d):
    return sum(n for t, n, _ in d.tokens if 0.0 <= t <= d.window_s) / d.window_s
