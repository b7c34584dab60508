"""Model FLOP utilisation of the whole step, in %: the model FLOPs a token
(the family's count: forward and backward, no recomputation) times the
untraced window's tokens/s, over the card's dense bf16 peak (989 TFLOP/s,
H100 SXM at 700 W; the card's power limit is printed at the start of the
run)."""


def read(ctx):
    if not ctx.tokens_per_s:
        return None
    return (100.0 * ctx.flops_per_token * ctx.tokens_per_s
            / ctx.peaks.BF16_FLOPS)
