// Host stand-in for <math_constants.h> (see cuda_runtime.h beside it).
#pragma once
#include <cmath>
#define CUDART_INF_F INFINITY
