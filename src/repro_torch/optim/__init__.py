from repro_torch.optim.schedules import (constant, cosine, inv_t,  # noqa: F401
                                         nonconvex_fixed,
                                         paper_strongly_convex)
from repro_torch.optim.sgd import sgd_init, sgd_step  # noqa: F401
