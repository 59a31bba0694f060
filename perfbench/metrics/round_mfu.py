"""round_mfu (%): the rounds' share of the card's roofline: the least time
the card could take for the work the rounds' inputs need (the kind's
``round_work``: operations by precision over their peaks, or bytes over
the memory rate, ``harness/peaks.py``), over the rounds' measured wall
time.  Rounds under the profiler are left out when others were measured.
The work is counted from the rows' nonzeros and the least evaluations the
lanes' FISTA steps need (or, for Newton, from the sketch, the Grams and
the solve), never from a dense staging of the rows or from what the
program launched.  Read on the card only: the peaks are the card's.
Moves round_s."""
from perfbench.harness import peaks


def read(ctx):
    if ctx.cell.device.type != "cuda":
        return None
    rounds = [r for r in ctx.window.rounds if not r.traced] \
        or ctx.window.rounds
    least = sum(peaks.least_seconds(ctx.cell.round_work(r)) for r in rounds)
    wall = sum(r.wall_s for r in rounds)
    if least <= 0 or wall <= 0:
        return None
    return 100.0 * least / wall
