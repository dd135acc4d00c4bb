// The FK walk the kernels take for a joint table (fk_spec.h), for the host:
// ops/kernels/panda_fields.py fk_variant asks it once per chain. Host code
// only; any C++17 compiler builds it.

#include "fk_spec.h"

extern "C" int fk_chain_variant(const FkChain* chain) { return fk_variant_of(*chain); }
