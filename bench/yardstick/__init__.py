"""What the benchmark measures against: the published peaks, the counted
work of a network, the traffic, the percentiles, the reduction of a device
trace and the comparison that decides ``correct``. Later changes to the
program leave these files as they are."""
