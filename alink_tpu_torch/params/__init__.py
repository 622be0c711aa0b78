from .shared import *  # noqa: F401,F403
