// The continuous NUTS machine with a low-rank-plus-diagonal inverse mass
// matrix, D (I + U (Lam - 1) U^T) D; the machine is in fused_nuts_dc.cuh.
#define BJT_DC_METRIC kLowRank
#include "fused_nuts_dc.cuh"
