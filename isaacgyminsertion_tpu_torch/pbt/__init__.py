from .pbt import PbtParams, PbtMember, pbt_update  # noqa: F401
from .mutation import mutate  # noqa: F401
