"""Sum of the expert FFN's bound over the traced stretch's MoE layers
(each expert with rows read once, rows in and out; from the loads the
engine handed the controller) over the device time of the expert FFN
kernels, in percent."""
from perfbench.core import readers as R


def read(ctx):
    return R.roofline(ctx, "expert_ffn", R.expert_bound_s)
