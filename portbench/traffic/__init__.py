"""Traffic generators.  Each reads a mix's parameters
(``mixes/<traffic>.json``) and the cell's load and draws the requests
from the seed.  Sizes are stratified: every block of consecutive requests
holds the same quantiles of the size distributions, in an order drawn
from the seed, so that every seed sends the same work in another order."""
