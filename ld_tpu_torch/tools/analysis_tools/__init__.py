"""The synthetic train-to-AP harnesses and the AP-landscape tool."""
