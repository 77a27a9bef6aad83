"""`notebook_utils` shim (SCT-GAN/notebook_utils.py)."""
from ..evals.notebook_utils import *            # noqa: F401,F403
from ..evals.notebook_utils import __all__      # noqa: F401
