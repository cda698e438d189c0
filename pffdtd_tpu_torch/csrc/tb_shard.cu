// K6: tb.cu built in shard mode (see the notes there), in a unit of its
// own so that nvcc compiles it beside tb.cu.
#define PF_TB_SHARD 1
#include "tb.cu"
