// A host stand-in for the constants of <math_constants.h> that the kernels use.
#pragma once
#include <limits>

#define CUDART_INF_F std::numeric_limits<float>::infinity()
