from .round import roundNum
