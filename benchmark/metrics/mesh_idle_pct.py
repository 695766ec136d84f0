"""Device (four H100s of a mesh): the mean over the cards of the share of
the traced window in which that card ran no kernel, copy or memset, in
percent (1 − ``busy_ns(card=c)`` / window, c = 0 … 3).  The union over all
cards would hide a card that sits idle while the others work."""

#: Cards of the mesh cells: cards 0 … CARDS − 1.
CARDS = 4


def read(trace, record):
    if not trace.device or not trace.cards or trace.window_ns() <= 0:
        return None
    idle = [1.0 - trace.busy_ns(card=c) / trace.window_ns() for c in range(CARDS)]
    return 100.0 * sum(idle) / CARDS
