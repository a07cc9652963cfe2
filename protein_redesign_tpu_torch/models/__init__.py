"""The port's network, schedule, masking, samplers and the model facade."""

from .diffusion import DiffusionSchedule, get_betas
from .denoiser import Denoiser, FoldingBlock
from .prdiff import ProteinReDiffModel
