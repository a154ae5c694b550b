"""The MDViT train step of the port: losses, optimizer and the MKD step."""
