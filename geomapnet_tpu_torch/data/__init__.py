"""Host data layer (numpy): RobotCar frames, MF tuples, batch loader."""
