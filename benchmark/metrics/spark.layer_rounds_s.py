"""``timer.totals["spark::layer_rounds"]``: the product layers' rounds
(``protocols/product_tree.py``) summed over a proof, mean a proof."""
from benchmark.readers import mean_of


def read(run):
    return mean_of(run, "prove_totals", "spark::layer_rounds")
