"""Member cluster models: FakeMemberCluster, the in-process capacity
simulator the propagation loop applies Works to (member.py)."""
