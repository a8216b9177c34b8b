"""The window's model FLOPs over the window, as a share of the card's
989 TFLOP/s dense fp16 and bf16 peak, in %.

Model FLOPs of each batch (``harness/bounds.batch_model_flops``): 2 x
the layers' matmul parameters for every token each request needs, the
head for every token whose logits are needed, and attention's QKᵀ and PV
over the positions each token attends to, from the configuration's
published widths. The private lookup's int8 work is left out: it has its
own roofline."""
from harness import bounds


def read(run):
    if run.kind != "generation" or run.window_s <= 0:
        return None
    flops = sum(bounds.batch_model_flops(run.dims, t, news)
                for t, news in run.batches)
    return 100.0 * flops / run.window_s / bounds.HALF_FLOPS_PER_S
