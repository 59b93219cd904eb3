"""The training runtime of the port: engine, lr schedules, loss scaler."""
