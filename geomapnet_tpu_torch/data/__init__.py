"""Host data layer (numpy): 7Scenes, RobotCar and synthetic frames, MF tuples
and MapNet++'s online composite, batch loader, decoded-frame cache; and the
device frame cache."""

from .composite import MF, MFOnline, OnlyPoses

__all__ = ["MF", "MFOnline", "OnlyPoses"]
