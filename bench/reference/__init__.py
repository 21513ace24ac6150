"""Plain NumPy reference of the rightsizer's timed paths: timeline
trimming, the mapping LP's certificate arithmetic and rounding, the paper's
greedy placement and protocol, and the CVaR fleet selection.  It imports
nothing of the program it judges."""
