"""Stats counters, fault points and the device-memory budget."""
