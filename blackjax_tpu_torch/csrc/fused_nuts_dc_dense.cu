// The continuous NUTS machine with a dense (d, d) inverse mass matrix; the
// machine is in fused_nuts_dc.cuh.
#define BJT_DC_METRIC kDense
#include "fused_nuts_dc.cuh"
