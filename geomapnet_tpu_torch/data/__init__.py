"""Host data layer (numpy): 7Scenes, RobotCar and synthetic frames, MF tuples,
batch loader, decoded-frame cache; and the device frame cache."""
