"""CPU rollout workers and the pool that feeds the learner. Importing the
package imports no torch: workers never touch CUDA."""
