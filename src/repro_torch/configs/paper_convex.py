"""The paper's own experimental settings (§6): l2-regularized logistic
regression and ridge regression, toy + shape-matched real-world stand-ins.
The same presets as ``repro.configs.paper_convex``."""
from repro_torch.config import ConvexConfig

# §6.1 toy: n=5000, d=20, lambda=1e-4
TOY_LOGISTIC = ConvexConfig(problem="logistic", n=5000, d=20, lam=1e-4)
TOY_RIDGE = ConvexConfig(problem="ridge", n=5000, d=20, lam=1e-4)

# real-world stand-ins, shape-matched (random data of the published shapes)
IJCNN1_LIKE = ConvexConfig(problem="logistic", n=35000, d=22, lam=1e-4)
MILLIONSONG_LIKE = ConvexConfig(problem="ridge", n=46371, d=90, lam=1e-4)  # 1/10 scale
SUSY_LIKE = ConvexConfig(problem="logistic", n=100000, d=18, lam=1e-4)     # 1/50 scale

# §6.2 distributed toy: d=1000, |Omega_s|=5000 per worker
DIST_TOY_LOGISTIC = ConvexConfig(problem="logistic", n=5000, d=1000, lam=1e-4, workers=8)
DIST_TOY_RIDGE = ConvexConfig(problem="ridge", n=5000, d=1000, lam=1e-4, workers=8)

PRESETS = {
    "toy-logistic": TOY_LOGISTIC,
    "toy-ridge": TOY_RIDGE,
    "ijcnn1": IJCNN1_LIKE,
    "millionsong": MILLIONSONG_LIKE,
    "susy": SUSY_LIKE,
    "dist-toy-logistic": DIST_TOY_LOGISTIC,
    "dist-toy-ridge": DIST_TOY_RIDGE,
}
