// K1 capacity, the standalone call (capacity.cuh holds the kernel).
#include "capacity.cuh"

extern "C" int kt_capacity(const CapacityArgs* a, void* stream) {
  return launch_capacity(*a, (cudaStream_t)stream);
}
