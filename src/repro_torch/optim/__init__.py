from repro_torch.optim.schedules import (constant, cosine, inv_t,  # noqa: F401
                                         nonconvex_fixed,
                                         paper_strongly_convex)
