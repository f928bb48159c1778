"""Whole step: model FLOPs done in the traced seconds over what the card's
bf16 peak (989 TFLOP/s) gives in that time, in percent.  The FLOPs are the
decode tokens of the rounds dispatched in them (``2 P`` a token plus its
attention pairs over the row's live slots) and the prefills whose
admission ended in them (each request's own spliced tokens, not the padded
bucket, and its image through the frozen tower and the projector);
``work.py`` counts them."""

from h100_bench import readings


def read(run):
    return readings.serve_mfu(run)
