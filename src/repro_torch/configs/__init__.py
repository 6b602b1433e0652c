# Workload configs of the port: the paper's own graph workloads (gre_paper).
