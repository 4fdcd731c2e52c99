"""The measurement operators, one module per degradation, found by the
traffic's `deg`: each defines Operator(traffic, data, rng, device) with
H(x_nhwc) -> (B, d_y) and d_y, its draws (a mask, a permutation) taken from
the numpy generator `rng` the harness makes from the seed."""
import importlib


def build(traffic: dict, data: dict, rng, device):
    return importlib.import_module(f"{__name__}.{traffic['deg']}").Operator(
        traffic, data, rng, device)
