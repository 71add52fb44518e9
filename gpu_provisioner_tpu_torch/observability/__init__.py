"""What the port's workloads expose to the control plane's scrape."""
