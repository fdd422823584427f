"""Command-line tools of the port: train, test, the AP-parity runbook, the
analysis tools and the deployment tools."""
